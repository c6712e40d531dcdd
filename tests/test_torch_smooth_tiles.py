"""PyTorch port: the tiling of K2 and K7's from_v smoothing block
(`csrc/common.cuh::smooth_from_v`), emulated on the CPU.

The kernel cannot run here, but its schedule can: every 64x64 window
smoothed alone (its halo from nsweeps as the launcher computes it, reads
past the window 0, cells past the array 0 with coefficients 0, red by the
array's parity), then the tiles stitched.  The window's shape and column
alignment are read from the CUDA source.  The result is held to
`fused_rb_sweeps_plain` (the global-barrier schedule) in float64, and must
equal it to the bit: each cell's update is the plain version's expression,
and a halo of 2·nsweeps+1 cells keeps every wrong value out of the tile.
An undersized halo, a wrong parity or a tile grid that misses a cell fails
here before any chip call.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.mg.levels import (
    build_fine_level,
    level_rows,
)
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, smoother
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    Coefs,
    as_dtype,
    coefs,
    neighbor_sum,
)

DT = torch.float64


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _source():
    return (_build.CSRC / "common.cuh").read_text()


def _window():
    """(rows, columns, column alignment) of the block's window, from the
    source."""
    const = dict(re.findall(r"constexpr int (FV_\w+) = (\d+);", _source()))
    return (int(const["FV_WIN_H"]), int(const["FV_WIN_W"]),
            int(const["FV_COL_ALIGN"]))


def _tile(nsweeps):
    """(halo rows, halo columns, tile rows, tile columns) at nsweeps."""
    wh, ww, align = _window()
    hr = 2 * nsweeps + 1
    hc = -(-hr // align) * align
    return hr, hc, wh - 2 * hr, ww - 2 * hc


def _emulate(level, u, corr, rhs, nsweeps, want_residual, rows_dec):
    """The block's schedule: (u, residual or None) after `nsweeps` sweeps
    from u (zeros if None) + corr."""
    wh, ww, _ = _window()
    hr, hc, th, tw = _tile(nsweeps)
    assert th >= 2 and tw >= 2
    rows, cols = level.padded
    ny, nx = -(-rows // th), -(-cols // tw)
    u0 = torch.zeros_like(rhs) if u is None else u
    if corr is not None:
        u0 = u0 + corr
    c = coefs(level)
    pad = lambda x: F.pad(x, (hc, nx * tw + hc - cols, hr, ny * th + hr - rows))
    fields = [pad(x) for x in (u0, rhs, c.aa, c.bb, c.cc, c.dd)]
    inv = as_dtype(1.0 / level.diag_a, DT)
    diag = as_dtype(level.diag_a, DT)
    u_out = torch.empty(ny * th, nx * tw, dtype=DT)
    res_out = torch.empty_like(u_out)
    for by in range(ny):
        for bx in range(nx):
            uw, rw, aa, bb, cc, dd = (
                x[by * th:by * th + wh, bx * tw:bx * tw + ww] for x in fields)
            cw = Coefs(aa, bb, cc, dd, None, None, level.diag_a)
            gi = torch.arange(wh)[:, None] + by * th - hr
            gj = torch.arange(ww)[None, :] + bx * tw - hc
            red = (gi + gj) % 2 == 0
            for _ in range(nsweeps):
                uw = torch.where(red, (rw - neighbor_sum(cw, uw)) * inv, uw)
                uw = torch.where(~red, (rw - neighbor_sum(cw, uw)) * inv, uw)
            res = rw - diag * uw - neighbor_sum(cw, uw)
            at = (slice(by * th, (by + 1) * th), slice(bx * tw, (bx + 1) * tw))
            u_out[at] = uw[hr:hr + th, hc:hc + tw]
            res_out[at] = res[hr:hr + th, hc:hc + tw]
    res_out = res_out[:rows, :cols]
    if rows_dec:
        res_out = res_out[::2]
    return u_out[:rows, :cols], res_out if want_residual else None


def _fine(n):
    vel = np.random.default_rng(7).standard_normal((2, n + 1, n + 1))
    return build_fine_level(vel[0], vel[1], 0.1 / n, -4e-4, dtype=DT,
                            device="cpu")


def _level(kind):
    """A whole level of n=64 (72x128) or n=128 (136x256), both with ragged
    last tiles; a 40x40 level that is a single tile; or a K7 block: rows
    [40, 100) of the n=128 level (row_off 40), whose rows past the array
    are interior rows of the grid."""
    if kind == "n64":
        return _fine(64)
    if kind == "n128":
        return _fine(128)
    if kind == "single tile":
        lv = _fine(32)
        return dataclasses.replace(lv, v1=lv.v1[:40, :40].contiguous(),
                                   v2=lv.v2[:40, :40].contiguous())
    return level_rows(_fine(128), 40, 100)


def _inputs(shape, seed=2024):
    """u, corr, rhs: random in every cell of the array."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(s * rng.standard_normal(shape))
            for s in (1.0, 1e-2, 1.0)]


FLAG_SETS = {
    "pre (zero_init, res_rows_dec)": dict(zero_init=True, rows_dec=True),
    "post (corr, residual)": dict(corr=True),
}


@pytest.mark.parametrize("flags", list(FLAG_SETS))
@pytest.mark.parametrize("nsweeps", [1, 3])
@pytest.mark.parametrize("kind", ["n64", "n128", "single tile"])
def test_stitched_windows_equal_the_plain_version(kind, nsweeps, flags):
    level = _level(kind)
    f = FLAG_SETS[flags]
    u, corr, rhs = _inputs(level.padded)
    if kind == "single tile":
        _, _, th, tw = _tile(nsweeps)
        assert level.padded[0] <= th and level.padded[1] <= tw
    zero, corr = f.get("zero_init", False), corr if f.get("corr") else None
    rows_dec = f.get("rows_dec", False)
    got = _emulate(level, None if zero else u, corr, rhs, nsweeps, True,
                   rows_dec)
    want = smoother.fused_rb_sweeps_plain(
        level, u, rhs, nsweeps, True, zero_init=zero, corr=corr,
        residual_rows_decimated=rows_dec)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("zero_init", [True, False])
def test_k7_block_with_interior_rows_past_it(zero_init):
    """K7: a block with an even row_off; cells past its rows stay 0 in the
    window (the from_v mask is 0 past the array), as the plain version's
    zero fill keeps them."""
    level = _level("k7 block")
    assert level.row_off == 40 and level.padded == (60, 256)
    u, _, rhs = _inputs(level.padded, seed=5)
    got = _emulate(level, None if zero_init else u, None, rhs, 3, True, False)
    want = smoother.fused_rb_sweeps_plain(level, u, rhs, 3, True,
                                          zero_init=zero_init)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_chain_of_launches_equals_one_schedule():
    """Past FROM_V_MAX_SWEEPS the wrapper chains launches; each launch is
    exact, so 20 sweeps from u + corr equal the plain version's."""
    level = _level("single tile")
    u, corr, rhs = _inputs(level.padded, seed=11)
    calls = []

    def launch(u, corr, k, last):
        calls.append((k, last))
        return _emulate(level, u, corr, rhs, k, last, False)

    got = smoother.in_launches(u, corr, 20, launch)
    want = smoother.fused_rb_sweeps_plain(level, u, rhs, 20, True, corr=corr)
    assert calls == [(smoother.FROM_V_MAX_SWEEPS, False),
                     (20 - smoother.FROM_V_MAX_SWEEPS, True)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_window_keeps_a_tile_up_to_the_wrappers_limit():
    """The source's window and halo rules against the wrapper's
    FROM_V_MAX_SWEEPS: a tile of at least 2x2 (even sides, so the colours
    of a tile's cells keep the array's parity) at the limit, none past
    it."""
    source = _source()
    assert "return 2 * nsweeps + 1;" in source
    assert ("(2 * nsweeps + FV_COL_ALIGN) / FV_COL_ALIGN * FV_COL_ALIGN"
            in source)
    assert "if (th < 2 || tw < 2) return cudaErrorInvalidValue;" in source
    limit = smoother.FROM_V_MAX_SWEEPS
    for ns in range(limit + 1):
        _, _, th, tw = _tile(ns)
        assert th >= 2 and tw >= 2 and th % 2 == 0 and tw % 2 == 0
    _, _, th, tw = _tile(limit + 1)
    assert th < 2 or tw < 2


def test_k2_and_k7_take_the_from_v_block():
    """mg_smooth launches smooth_from_v; K3, K4, K5, K6 and K8 keep
    smooth_tile."""
    smoother_cu = (_build.CSRC / "smoother.cu").read_text()
    body = smoother_cu[smoother_cu.index("int smooth(const T* u"):
                       smoother_cu.index("int smooth5(")]
    assert "launch_smooth_from_v(" in body
    assert "smooth_v_kernel<T, mg::FV_PAIRED>" in body
    assert "smooth_v_kernel<T, mg::FV_SINGLES>" in body
    assert "smooth_tile" not in body and "FORM_FROM_V" not in body
    assert "mg::smooth_from_v<T, ACCESS>(a);" in smoother_cu
    assert "mg::FORM_FIVE>(" in smoother_cu and "mg::FORM_NINE>(" in smoother_cu
    for other in ("tower.cu", "delta_step.cu"):
        text = (_build.CSRC / other).read_text()
        assert "mg::smooth_tile<T, mg::FORM_FROM_V" in text
        assert "smooth_from_v" not in text
