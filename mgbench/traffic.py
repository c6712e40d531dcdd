"""The one generator of inputs: a bank of initial conditions from the seed.

A traffic file's "inputs" says how many initial conditions the bank holds
("bank") and the box their centres are drawn from ("centre_box": [lo, hi]
on both axes, away from the boundary); the configuration gives the grid
and the Gaussian's width.  The centres come from a `torch.Generator` on
the run's device, seeded by `--seed`, so the same seed gives the same
bank; every seed gives the same sizes and the same amount of work.
"""

from __future__ import annotations

import torch

# the seed's low 64 bits seed the generator (a seed may exceed 32 bits)
_SEED_MASK = (1 << 63) - 1


def centres(seed: int, inputs: dict, device) -> torch.Tensor:
    """(bank, 2) float64 centres (x0, y0), drawn uniformly in the box."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _SEED_MASK)
    lo, hi = inputs["centre_box"]
    u = torch.rand((inputs["bank"], 2), generator=gen, dtype=torch.float64,
                   device=device)
    return lo + (hi - lo) * u


def gaussian_bank(seed: int, config: dict, inputs: dict,
                  device) -> torch.Tensor:
    """(bank, n+1, n+1) float64 initial conditions exp(−σ|x − c|²) on the
    logical node grid, boundary ring zero, made on `device` in one call."""
    n, sigma = config["n"], config["sigma"]
    c = centres(seed, inputs, device)
    idx = torch.arange(n + 1, dtype=torch.float64, device=device) * (1.0 / n)
    dx = idx[None, :, None] - c[:, 0, None, None]
    dy = idx[None, None, :] - c[:, 1, None, None]
    bank = torch.exp(-sigma * (dx * dx + dy * dy))
    bank[:, 0, :] = bank[:, -1, :] = 0.0
    bank[:, :, 0] = bank[:, :, -1] = 0.0
    return bank


def order(run: int, inputs: dict) -> int:
    """The bank entry run number `run` takes: the bank in turn."""
    return run % inputs["bank"]
