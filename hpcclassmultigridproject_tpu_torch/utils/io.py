"""Field I/O in the reference's text-dump format, the port's copy of the
JAX package's `utils/io.py` (numpy only; a torch tensor is moved to the
host first).

`save_field_txt`/`load_field_txt` write and read tab-separated `%f` rows,
the format of the reference's uT.txt; `save_field`/`load_field` use .npy
for lossless round trips.
"""

from __future__ import annotations

import pathlib

import numpy as np


def as_numpy(field) -> np.ndarray:
    """A numpy array of a field: a torch tensor (any device) or array-like."""
    if hasattr(field, "detach"):
        return field.detach().cpu().numpy()
    return np.asarray(field)


def save_field_txt(path, field) -> None:
    """Tab-separated text dump, one grid row per line."""
    np.savetxt(path, as_numpy(field), fmt="%f", delimiter="\t")


def load_field_txt(path) -> np.ndarray:
    return np.loadtxt(path)


def save_field(path, field) -> None:
    np.save(path, as_numpy(field))


def load_field(path) -> np.ndarray:
    return np.load(path)


def field_difference_norm(a, b) -> float:
    """Frobenius norm of the difference of two fields."""
    return float(np.linalg.norm(as_numpy(a) - as_numpy(b)))


def ensure_dir(path) -> pathlib.Path:
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p
