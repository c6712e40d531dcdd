"""PyTorch port: the device memory the delta form's float64 parts ask
for, counted on the CPU (scripts/torch_live_fields.py: the most float64
fields of level 0's shape that a part's tensors hold at once).

The float64 certificate and the epilogue hold a run's peak: on four
cards at n=32768 by rows the graph's pool, sized by them, left a rank
short of the memory the gather of uT needed.  Each drops every field
once used and makes A's bands one at a time
(`blocks.level_neighbor_sums`), with the same bits: each of its sums
equals `neighbor_sum` to the bit here on every level form and on a row
block, and the runs are held to the JAX package by
tests/test_torch_delta.py and to one device by the partitioned tests.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.ops import padded
from hpcclassmultigridproject_tpu_torch.parallel import (
    Mesh,
    blocks,
    distributed,
)
from hpcclassmultigridproject_tpu_torch.parallel.sharding import RowBlocks

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "scripts"))
from torch_live_fields import live_fields  # noqa: E402


@pytest.fixture(scope="module")
def fields():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return live_fields(64)
    finally:
        torch.set_num_threads(old)


@pytest.mark.parametrize("part,most", [("f64 certificate", 8.5),
                                       ("epilogue", 8.0)])
def test_float64_parts_hold_few_fields(fields, part, most):
    """The certificate and the epilogue hold at most 8.5 and 8 float64
    fields at once (13.5 and 14.5 before each field was dropped once used
    and the bands made one at a time)."""
    assert fields[part] <= most + 0.01, fields


def _levels():
    """A from_v level in float64 (the certificates' fine_hi) and the
    Poisson and Galerkin forms (stored bands)."""
    model = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=1),
        SolverConfig(dtype=torch.float64, refine_dtype=torch.float64,
                     delta_form=True, cycle_mode="fixed", num_cycles=1,
                     coarse_mode="dense", certify_every=1), device="cpu")
    galerkin = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=1),
        SolverConfig(dtype=torch.float64, coarse_operator="galerkin"),
        device="cpu")
    return {"from_v": model.fine_hi, "galerkin": galerkin.levels[1]}


@pytest.mark.parametrize("form", ["from_v", "galerkin"])
def test_level_neighbor_sums_are_neighbor_sums(form):
    """One u or two (the epilogue's u_prev and uT), each sum equal to
    `neighbor_sum` on the level's stored or recomputed bands."""
    level = _levels()[form]
    rng = np.random.default_rng(7)
    us = [torch.from_numpy(rng.standard_normal(level.padded))
          for _ in range(2)]
    want = [padded.neighbor_sum(padded.coefs(level), u) for u in us]
    (one,) = padded.level_neighbor_sums(level, us[:1])
    assert torch.equal(one, want[0])
    both = padded.level_neighbor_sums(level, us)
    assert all(torch.equal(g, w) for g, w in zip(both, want))


def test_level_neighbor_sums_on_a_row_block():
    """On a row block (one rank's view, its halo given) the lean sum
    equals the stored bands' sum on the block's window, to the bit."""
    level = _levels()["from_v"]
    rows, cols = level.padded
    part = RowBlocks(Mesh(2, 1), local=rows // 2, rows=rows, cols=cols,
                     halo=8)
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.standard_normal(level.padded))
    block = u[part.start:part.stop]
    # the last rank's halo below is a zero row past the array
    ext = distributed.fit(u, part.span + 1)[part.start - 1:part.stop + 1]
    halo = blocks.halo_level(level, part)
    want = padded.neighbor_sum(padded.coefs(halo), ext)[1:-1]
    (got,) = padded.level_neighbor_sums(halo, [ext])
    got = got[1:-1]
    assert torch.equal(got, want)
    assert got.shape == block.shape
