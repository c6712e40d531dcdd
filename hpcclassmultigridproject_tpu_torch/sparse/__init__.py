"""Sparse coarse operators: the Galerkin R·A·P bands (galerkin.py)."""
