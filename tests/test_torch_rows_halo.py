"""PyTorch port: the deep-halo smoothing of a row-partitioned level
(parallel/rows_halo.py, K7's plain version) in one process, with no
process group: each rank's halos are cut from the whole field, as the
exchange delivers them (rank 0's top and the last rank's bottom are the
zero rows past the grid).

The stitched centre rows of every rank's block equal the single-device
plain smoother on the whole field bitwise: each centre row goes through
the same eager torch ops on the same values.  The overlap schedule equals
the plain one bitwise.  Against the JAX package's `fused_smooth_sharded`
on a JAX CPU mesh (Pallas in interpret mode), f64 atol 1e-13
(tests/test_halo.py's bound).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import pad_field
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    build_fine_level,
    level_rows,
)
from hpcclassmultigridproject_tpu_torch.models.poisson import (
    build_poisson_hierarchy,
)
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
    fused_rb_sweeps,
    fused_rb_sweeps_plain,
    fused_rb_sweeps_rows,
)
from hpcclassmultigridproject_tpu_torch.parallel import Mesh, rows_halo
from hpcclassmultigridproject_tpu_torch.parallel.sharding import (
    level_shardings_for_ns,
    shard_level_data,
)

_DTYPES = {"f64": torch.float64, "f32": torch.float32}
_FLAGS = {
    "plain": dict(want_residual=False, zero_init=False),
    "zero_init": dict(want_residual=True, zero_init=True),
    "want_residual": dict(want_residual=True, zero_init=False),
}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _velocities(rng, n):
    shape = (n + 1, n + 1)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _setup(n, dtype, seed=21):
    """A from_v level on random velocities and random (u, rhs), zero
    outside the open interior (tests/test_halo.py's fields)."""
    rng = np.random.default_rng(seed)
    shape = (n + 1, n + 1)
    v1, v2 = _velocities(rng, n)
    level = build_fine_level(v1, v2, (1.0 / n) / 10, -4e-4, dtype=dtype,
                             device="cpu")
    fields = []
    for _ in range(2):
        x = np.zeros(shape)
        x[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        fields.append(pad_field(torch.from_numpy(x)).to(dtype))
    return level, *fields


def _rank_inputs(level, fields, world, rank):
    """Rank `rank`'s cut level, partition, blocks and given halos."""
    (part,) = level_shardings_for_ns([level.n], Mesh(world, rank),
                                     min_local=1)
    h = part.halo
    ext = [F.pad(x, (0, 0, h, part.span - x.shape[0] + h))
           [part.start:part.stop + 2 * h] for x in fields]
    blocks = [x[h:h + part.local] for x in ext]
    halos = [(x[:h], x[h + part.local:]) for x in ext]
    return shard_level_data(level, part), part, blocks, halos


def _stitched(level, fields, world, nsweeps, want_residual, zero_init,
              overlap=False):
    """Every rank's smooth_block on its emulated halos, stitched."""
    outs = []
    for rank in range(world):
        cut, part, blocks, halos = _rank_inputs(level, fields, world, rank)
        if zero_init:
            blocks, halos = blocks[1:], halos[1:]
        outs.append(rows_halo.smooth_block(
            cut, part, blocks, rows_halo.Exchange.given(halos), nsweeps,
            want_residual, zero_init, overlap))
    return [None if outs[0][i] is None else torch.cat([o[i] for o in outs])
            for i in (0, 1)]


def _assert_stitched_equal(got, want, rows):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert torch.equal(g[:rows], w), float((g[:rows] - w).abs().max())
        assert not g[rows:].any()


@pytest.mark.parametrize("flags", list(_FLAGS))
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("world", [2, 4])
def test_stitched_blocks_equal_whole_field(world, n, dtype, flags):
    level, u, rhs = _setup(n, _DTYPES[dtype])
    kw = _FLAGS[flags]
    want = fused_rb_sweeps_plain(level, u, rhs, 3, **kw)
    got = _stitched(level, (u, rhs), world, 3, **kw)
    _assert_stitched_equal(got, want, level.padded[0])


@pytest.mark.parametrize("zero_init", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_overlap_schedule_equals_plain(world, zero_init):
    """tests/test_halo.py's overlap test: K7 on the raw block plus the two
    3h-row edge slabs, stitched, is the plain schedule to the bit."""
    level, u, rhs = _setup(128, torch.float32)
    kw = dict(want_residual=True, zero_init=zero_init)
    plain = _stitched(level, (u, rhs), world, 3, **kw)
    over = _stitched(level, (u, rhs), world, 3, overlap=True, **kw)
    for a, b in zip(over, plain):
        assert torch.equal(a, b)


def test_five_band_blocks_run_without_offset():
    """A five-band (Poisson) level smooths its extended blocks through K5's
    plain version: the stored bands carry the interior mask."""
    level = build_poisson_hierarchy(64, 1, dtype=torch.float64,
                                    device="cpu")[0]
    rng = np.random.default_rng(3)
    u, rhs = (torch.from_numpy(np.pad(rng.standard_normal((63, 63)),
                                      ((1, 8), (1, 64))))
              for _ in range(2))
    assert level.form == "five" and u.shape == level.padded
    want = fused_rb_sweeps_plain(level, u, rhs, 3, want_residual=True)
    got = _stitched(level, (u, rhs), 2, 3, want_residual=True,
                    zero_init=False)
    _assert_stitched_equal(got, want, level.padded[0])


def test_odd_row_off_raises():
    """K7 takes a cell's colour from its array row: an odd offset would
    swap red and black, so the wrapper refuses it; K2 refuses a block."""
    level, u, rhs = _setup(64, torch.float64)
    odd = level_rows(level, 3, 3 + 40)
    with pytest.raises(ValueError, match="odd"):
        fused_rb_sweeps_rows(odd, u[:40], rhs[:40], 3)
    even = level_rows(level, 8, 48)
    fused_rb_sweeps_rows(even, u[8:48].contiguous(), rhs[8:48].contiguous(),
                         3)
    with pytest.raises(ValueError, match="fused_rb_sweeps_rows"):
        fused_rb_sweeps(even, u[8:48], rhs[8:48], 3)


def test_nine_band_level_raises():
    import dataclasses

    level, u, rhs = _setup(64, torch.float64)
    nine = dataclasses.replace(level, v1=None, v2=None, aa=level.v1,
                               bb=level.v1, cc=level.v1, dd=level.v1,
                               ne=level.v1, nw=level.v1, se=level.v1,
                               sw=level.v1, diag=level.v1)
    (part,) = level_shardings_for_ns([64], Mesh(2, 0), min_local=1)
    with pytest.raises(NotImplementedError, match="5-point levels only"):
        rows_halo.fused_smooth_sharded(part, nine, u, rhs, 3)


def test_cut_level_holds_its_rows_and_halo():
    level, _, _ = _setup(64, torch.float64)
    (part,) = level_shardings_for_ns([64], Mesh(4, 1), min_local=1)
    cut = shard_level_data(level, part)
    h = part.halo
    assert cut.row_off == part.start - h and cut.padded == (
        part.local + 2 * h, level.padded[1])
    assert torch.equal(cut.v1, level.v1[part.start - h:part.stop + h])
    last = shard_level_data(level, level_shardings_for_ns(
        [64], Mesh(4, 3), min_local=1)[0])
    assert not last.v1[level.padded[0] - last.row_off:].any()


def test_padded_rows_and_halo_match_jax():
    from hpcclassmultigridproject_tpu.ops.pallas.smoother import _halo
    from hpcclassmultigridproject_tpu.parallel import pallas_halo

    for ndev in (1, 2, 3, 4, 8):
        assert rows_halo._row_multiple(ndev) == pallas_halo._row_multiple(ndev)
        for rows in range(1, 1100, 7):
            assert rows_halo.padded_rows_for(rows, ndev) == \
                pallas_halo.padded_rows_for(rows, ndev)
    for nsweeps in range(1, 7):
        assert rows_halo.halo_rows(nsweeps) == _halo(nsweeps)
    # deeper nesting: blocks of every partitioned level start at even rows
    for ndev in (2, 4, 8):
        for depth in (1, 2, 3):
            local = rows_halo.padded_rows_for(1032, ndev, depth) // ndev
            assert (local >> (depth - 1)) % 2 == 0


@pytest.mark.parametrize("zero_init", [False, True])
def test_block_matches_jax_fused_smooth_sharded(zero_init):
    """The port's stitched blocks against the JAX package's sharded fused
    Pallas smoother (interpret mode) on a 4-device CPU mesh, n=64, f64."""
    import jax
    import jax.numpy as jnp

    import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
    from hpcclassmultigridproject_tpu.mg.levels import (
        build_fine_level as j_build_fine_level,
    )
    from hpcclassmultigridproject_tpu.parallel import make_mesh
    from hpcclassmultigridproject_tpu.parallel.pallas_halo import (
        fused_smooth_sharded,
    )

    n, world = 64, 4
    level, u, rhs = _setup(n, torch.float64)
    old = psm.INTERPRET
    psm.INTERPRET = True
    try:
        v1, v2 = _velocities(np.random.default_rng(21), n)
        jlevel = j_build_fine_level(jnp.asarray(v1), jnp.asarray(v2),
                                    (1.0 / n) / 10, -4e-4, dtype=jnp.float64)
        mesh = make_mesh(jax.devices()[:world])
        ju = None if zero_init else jnp.asarray(u.numpy())
        want = fused_smooth_sharded(mesh, jlevel, ju, jnp.asarray(rhs.numpy()),
                                    3, want_residual=True,
                                    zero_init=zero_init)
    finally:
        psm.INTERPRET = old
    got = _stitched(level, (u, rhs), world, 3, want_residual=True,
                    zero_init=zero_init)
    rows = level.padded[0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:rows].numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
