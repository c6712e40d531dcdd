"""Sparse operators: the Galerkin R·A·P bands (galerkin.py) and the
explicit-matrix path (matrix.py)."""
