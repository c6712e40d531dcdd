"""Field I/O, the port's copy of the JAX package's `utils/io.py` (numpy
only; a torch tensor is moved to the host first).

`save_field_txt` writes the JAX package's dense tab-separated rows, one
grid row a line, but with the digits of an exact round trip (`%.9g` for
float32 and narrower, `%.17g` otherwise) where the JAX package writes `%f`
and keeps six decimals.  `load_field_txt` reads those rows, and the C++
reference's `i\tj\tvalue` triplet dumps (multigrid.cpp:269-275), told
apart by their shape.  `save_field`/`load_field` use .npy.
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
    """Tab-separated text dump, one grid row per line, every value with the
    digits that read back to it exactly; the JAX package's `np.loadtxt`
    reads it as its own."""
    arr = as_numpy(field)
    fmt = "%.9g" if arr.dtype.itemsize <= 4 else "%.17g"
    np.savetxt(path, arr, fmt=fmt, delimiter="\t")


def load_field_txt(path) -> np.ndarray:
    """A dumped field as float64: dense rows, or the reference's triplet
    lines `i\tj\tvalue`, one node a line (three columns and not three
    rows: a dense field is square).  Triplets must cover the grid once."""
    arr = np.loadtxt(path)
    if arr.ndim != 2 or arr.shape[1] != 3 or arr.shape[0] == 3:
        return arr
    ij = arr[:, :2]
    rows, cols = (int(v) + 1 for v in ij.max(axis=0))
    field = np.full((rows, cols), np.nan)
    if (np.any(ij != np.round(ij)) or ij.min() < 0
            or rows * cols != arr.shape[0]):
        raise ValueError(f"{path}: three columns, but not i, j, value "
                         "triplets of a whole grid")
    field[ij[:, 0].astype(int), ij[:, 1].astype(int)] = arr[:, 2]
    if np.isnan(field).any():
        raise ValueError(f"{path}: triplets leave grid nodes unset")
    return field


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
