"""Carry the JAX package's state into the port.

The port never imports JAX.  A caller that holds the JAX package's levels
extracts each one's fields as numpy arrays and static numbers (v1, v2,
a_inv, n, h, dt, nu, diag_a, diag_b), and `levels_from_numpy` turns them
into the port's levels, so that both packages can run from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.mg.levels import Level

_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")


def level_from_numpy(d: dict, *, device, dtype=None) -> Level:
    """One port level from one JAX level's fields; dtype None keeps the
    arrays' own."""
    a_inv = d.get("a_inv")
    as_t = lambda a: torch.from_numpy(np.array(a)).to(device=device,
                                                     dtype=dtype)
    return Level(
        v1=as_t(d["v1"]), v2=as_t(d["v2"]),
        a_inv=None if a_inv is None else as_t(a_inv),
        n=int(d["n"]), **{k: float(d[k]) for k in _STATIC[1:]},
    )


def levels_from_numpy(level_dicts, fine_hi_dict, u0, *, device,
                      dtype: torch.dtype):
    """Port levels from the JAX package's level fields.

    `level_dicts` holds one dict per level (finest first); `fine_hi_dict`
    is the high-precision fine operator's dict and `u0` the padded initial
    state.  The levels land on `device` in `dtype`; the fine operator and
    u0 keep their own float dtype (float64 in the delta configuration).
    Returns (levels, fine_hi, u0)."""
    levels = tuple(level_from_numpy(d, device=device, dtype=dtype)
                   for d in level_dicts)
    fine_hi = level_from_numpy(fine_hi_dict, device=device)
    u0_t = torch.from_numpy(np.array(u0)).to(device)
    return levels, fine_hi, u0_t
