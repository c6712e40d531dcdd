"""PyTorch port: the tiling of the from_v smoothing block
(`csrc/common.cuh::smooth_from_v`) that K2, K5, K6, K7 and every level of
the coarse tower (K3, K4: `csrc/tower.cu`) launch, emulated on the CPU.

The kernel cannot run here, but its schedule can: every 64x64 window
smoothed alone (its halo from nsweeps as the launcher computes it, reads
past the window 0, cells past the array 0 with coefficients 0 and a
nine-band diagonal of 1, red by the array's parity), then the tiles
stitched.  Its coefficients are the level's: recomputed from (v1, v2)
(K2, K7), or the stored bands and scalar diagonal (K5), or also the
corners, read at their values from before the pass, and the varying
diagonal (K6).  The window's shape and column
alignment are read from the CUDA source.  The result is held to
`fused_rb_sweeps_plain` (the global-barrier schedule) in float64, and must
equal it to the bit: each cell's update is the plain version's expression,
and a halo of 2·nsweeps+1 cells keeps every wrong value out of the tile.
An undersized halo, a wrong parity or a tile grid that misses a cell fails
here before any chip call.

The tower's schedule is emulated the same way, level by level: its
descent injects each tile's residual at even nodes into the coarser rhs
and writes 0 to the coarse cells past the fine array (every coarse cell
exactly once), its ascent adds the per-point prolongation as the window is
loaded, and a level past FV_MAX_SWEEPS runs as a chain of links; both are
held bit for bit to `tower_descend_plain` and `tower_ascend_plain`.

So is K8's (`csrc/delta_step.cu`, the block's FV_OPEN variant): every
window opened alone, its (hi', lo') from its own cells and 0 past it, its
rhs from in-window neighbours only, then the cascade from zero; past
FV_MAX_SWEEPS K2 links follow.  It is held bit for bit to
`fused_open_presmooth_plain`, and a halo one row short must fail.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.mg import delta
from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    BANDS,
    CORNERS,
    build_fine_level,
    build_hierarchy,
    level_rows,
)
from hpcclassmultigridproject_tpu_torch.models.poisson import poisson_level
from hpcclassmultigridproject_tpu_torch.ops.cuda import (
    _build,
    delta_step,
    smoother,
    tower,
)
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


def _cascade(cw, uw, rw, red, diag, inv, nsweeps):
    """`nsweeps` red-black sweeps and the residual on one window, reads past
    it 0: (u, residual)."""
    for _ in range(nsweeps):
        uw = torch.where(red, (rw - neighbor_sum(cw, uw)) * inv, uw)
        uw = torch.where(~red, (rw - neighbor_sum(cw, uw)) * inv, uw)
    return uw, rw - diag * uw - neighbor_sum(cw, uw)


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
    nine = c.corners is not None
    pad = lambda x, fill=0.0: F.pad(
        x, (hc, nx * tw + hc - cols, hr, ny * th + hr - rows), value=fill)
    fields = [pad(x) for x in (u0, rhs, c.aa, c.bb, c.cc, c.dd,
                               *(c.corners or ()))]
    # the nine-band diagonal is 1 past the array, as outside the interior
    diag_f = pad(c.diag, 1.0) if nine else None
    u_out = torch.empty(ny * th, nx * tw, dtype=DT)
    res_out = torch.empty_like(u_out)
    for by in range(ny):
        for bx in range(nx):
            at = (slice(by * th, by * th + wh), slice(bx * tw, bx * tw + ww))
            uw, rw, aa, bb, cc, dd, *corners = (x[at] for x in fields)
            if nine:
                diag = diag_f[at]
                inv = 1.0 / diag
            else:
                diag = as_dtype(level.diag_a, DT)
                inv = as_dtype(1.0 / level.diag_a, DT)
            cw = Coefs(aa, bb, cc, dd, tuple(corners) or None,
                       diag if nine else None, level.diag_a)
            gi = torch.arange(wh)[:, None] + by * th - hr
            gj = torch.arange(ww)[None, :] + bx * tw - hc
            uw, res = _cascade(cw, uw, rw, (gi + gj) % 2 == 0, diag, inv,
                               nsweeps)
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


# K5 and K6: the same block with the level's stored bands

# chip_smoke.py's four flag sets of K5 and K6 (BAND_FLAG_SETS)
BAND_FLAG_SETS = {
    "zero_init, residual": dict(zero_init=True),
    "zero_init, res_rows_dec": dict(zero_init=True, rows_dec=True),
    "corr": dict(corr=True, residual=False),
    "u, residual": {},
}


def _band_level(form, kind):
    """A five-band Poisson level at n=64, or the nine-band Galerkin R·A·P
    level at n=64 below a CN level at n=128 (both 72x128: 2x3 windows at
    nsweeps 3); "single tile" cuts every stored array to 40x40."""
    if form == "five":
        level = poisson_level(64, 1.0 / 64, dtype=DT, device="cpu")
    else:
        vel = np.random.default_rng(7).standard_normal((2, 129, 129))
        level = build_hierarchy(vel[0], vel[1], 0.1 / 128, -4e-4, 2,
                                dtype=DT, device="cpu",
                                coarse_operator="galerkin")[1]
    assert level.form == form and level.padded == (72, 128)
    if kind == "single tile":
        names = (*BANDS, *CORNERS, "diag") if form == "nine" else BANDS
        level = dataclasses.replace(level, **{
            k: getattr(level, k)[:40, :40].contiguous() for k in names})
    return level


@pytest.mark.parametrize("flags", list(BAND_FLAG_SETS))
@pytest.mark.parametrize("nsweeps", [1, 3])
@pytest.mark.parametrize("kind", ["level", "single tile"])
@pytest.mark.parametrize("form", ["five", "nine"])
def test_band_windows_equal_the_plain_version(form, kind, nsweeps, flags):
    """K5 and K6: the stitched windows of a Poisson and a Galerkin level,
    and of a level that is a single tile, bit for bit against the plain
    version in every flag set of their paths."""
    level = _band_level(form, kind)
    if kind == "single tile":
        _, _, th, tw = _tile(nsweeps)
        assert level.padded[0] <= th and level.padded[1] <= tw
    f = BAND_FLAG_SETS[flags]
    u, corr, rhs = _inputs(level.padded, seed=nsweeps)
    zero, corr = f.get("zero_init", False), corr if f.get("corr") else None
    rows_dec, want_res = f.get("rows_dec", False), f.get("residual", True)
    got = _emulate(level, None if zero else u, corr, rhs, nsweeps, want_res,
                   rows_dec)
    want = smoother.fused_rb_sweeps_plain(
        level, u, rhs, nsweeps, want_res, zero_init=zero, corr=corr,
        residual_rows_decimated=rows_dec)
    assert torch.equal(got[0], want[0])
    if want_res:
        assert got[1].shape == want[1].shape and torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("form", ["five", "nine"])
def test_a_chain_of_band_launches_equals_one_schedule(form):
    """K5 and K6 take any nsweeps as K2 does: 20 sweeps from u + corr as a
    chain of FROM_V_MAX_SWEEPS and the rest, equal to the plain
    version's."""
    level = _band_level(form, "single tile")
    u, corr, rhs = _inputs(level.padded, seed=13)
    calls = []

    def launch(u, corr, k, last):
        calls.append((k, last))
        return _emulate(level, u, corr, rhs, k, last, False)

    got = smoother.in_launches(u, corr, 20, launch)
    want = smoother.fused_rb_sweeps_plain(level, u, rhs, 20, True, corr=corr)
    assert calls == [(smoother.FROM_V_MAX_SWEEPS, False),
                     (20 - smoother.FROM_V_MAX_SWEEPS, True)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k6_corner_words_fit_the_blocks_shared_memory():
    """K6's block: the static column planes plus the dynamic corner words
    (FV_NINE_WORDS a cell) fit the 232,448 bytes a block may have in
    float64, and two blocks an SM's 233,472 in float32 (1 KB of each
    block's reserved), the occupancy its register budget is set for."""
    source = _source()
    const = dict(re.findall(r"constexpr int (FV_\w+) = (\d+);", source))
    wh, ww, _ = _window()
    rows, threads = wh // int(const["FV_WARPS"]), ww // 2 * int(
        const["FV_WARPS"])
    planes = 2 * (wh + 2) * (ww // 2 + 2)
    words = int(const["FV_NINE_WORDS"]) * rows * 2 * threads
    assert "return sizeof(T) == 4 ? 2 : 1;" in source  # fv_min_blocks
    assert (planes + words) * 8 <= 232448
    assert 2 * ((planes + words) * 4 + 1024) <= 233472


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
    """mg_smooth launches smooth_from_v, and so do mg_smooth5 and
    mg_smooth9 (K5, K6: the coefficient source a compile-time variant), the
    tower's two kernels (K3, K4), each in one cooperative launch, and K8
    (mg_open_smooth: the opening a compile-time variant); the 32x32
    smooth_tile block is gone."""
    smoother_cu = (_build.CSRC / "smoother.cu").read_text()
    body = smoother_cu[smoother_cu.index("int smooth(const T* u"):
                       smoother_cu.index("int smooth5(")]
    assert "launch_smooth_from_v(" in body
    assert "smooth_v_kernel<T, mg::FV_PAIRED>" in body
    assert "smooth_v_kernel<T, mg::FV_SINGLES>" in body
    assert "FORM_FROM_V" not in body
    assert "mg::smooth_from_v<T, ACCESS>(" in smoother_cu
    assert ("mg::smooth_from_v<T, ACCESS, mg::FV_SMOOTH, FORM>("
            in smoother_cu)
    for entry, form in (("int smooth5(", "FORM_FIVE"),
                        ("int smooth9(", "FORM_NINE")):
        start = smoother_cu.index(entry)
        body = smoother_cu[start:smoother_cu.index("\n}\n", start)]
        assert "mg::launch_smooth_from_v(" in body
        for access in ("FV_PAIRED", "FV_SINGLES"):
            assert f"smooth_bands_kernel<T, mg::{access}, mg::{form}>" in body
    assert "mg::fv_nine_smem_bytes<T>()" in smoother_cu
    tower_cu = (_build.CSRC / "tower.cu").read_text()
    assert "mg::smooth_from_v<T, ACCESS, XFER>(" in tower_cu
    assert "run_link<T, ACCESS, mg::FV_INJECT>" in tower_cu
    assert "run_link<T, ACCESS, mg::FV_PROLONG>" in tower_cu
    assert "cudaLaunchCooperativeKernel(" in tower_cu
    assert "<<<" not in tower_cu
    delta_cu = (_build.CSRC / "delta_step.cu").read_text()
    assert "mg::smooth_from_v<T, ACCESS, mg::FV_OPEN>(" in delta_cu
    start = delta_cu.index("int open_smooth(")
    body = delta_cu[start:delta_cu.index("\n}\n", start)]
    assert "mg::launch_smooth_from_v(" in body
    for access in ("FV_PAIRED", "FV_SINGLES"):
        assert f"open_smooth_kernel<T, mg::{access}>" in body
    for path in sorted(_build.CSRC.iterdir()):
        text = path.read_text()
        for gone in ("smooth_tile", "launch_smooth(", "smooth_smem_bytes",
                     "TILE_H", "TILE_W", "SMOOTH_THREADS", "SMOOTH_PLANES"):
            assert gone not in text, (path.name, gone)


# K8: the whole-step opening on the from_v block (FV_OPEN)


def _emulate_open(level, hi, lo, d, nsweeps, want_residual, rows_dec,
                  short=0):
    """K8's schedule: (hi', lo', rhs, u, residual or None) after the opening
    and `nsweeps` sweeps from zero, every window alone; `short` rows taken
    off the halo (the tile growing by as many on each side)."""
    wh, ww, _ = _window()
    hr, hc, th, tw = _tile(nsweeps)
    hr, th = hr - short, th + 2 * short
    assert th >= 2 and tw >= 2
    rows, cols = level.padded
    ny, nx = -(-rows // th), -(-cols // tw)
    c = coefs(level)
    pad = lambda x: F.pad(x, (hc, nx * tw + hc - cols, hr,
                              ny * th + hr - rows))
    fields = [pad(x) for x in (hi, lo, d, level.v1, level.v2, c.aa, c.bb,
                               c.cc, c.dd)]
    two_rnu, r_h = (as_dtype(x, DT)
                    for x in delta.difference_form_constants(level))
    diag = as_dtype(level.diag_a, DT)
    inv = as_dtype(1.0 / level.diag_a, DT)
    outs = [torch.empty(ny * th, nx * tw, dtype=DT) for _ in range(5)]
    for by in range(ny):
        for bx in range(nx):
            at = (slice(by * th, by * th + wh), slice(bx * tw, bx * tw + ww))
            h, l, x, v1, v2, aa, bb, cc, dd = (f[at] for f in fields)
            # (hi', lo') from the window's own cells, 0 past the array
            hi2, lo2 = delta._accumulate(h, l, x)
            gi = torch.arange(wh)[:, None] + by * th - hr
            gj = torch.arange(ww)[None, :] + bx * tw - hc
            m = ((gi >= 1) & (gi <= level.n - 1) & (gj >= 1)
                 & (gj <= level.n - 1)).to(DT)
            # the rhs from in-window neighbours, 0 past the window
            lap, di, dj = delta._dform(hi2)
            lap_l, di_l, dj_l = delta._dform(lo2)
            lap, di, dj = lap + lap_l, di + di_l, dj + dj_l
            rw = (-(two_rnu * lap) - r_h * (v1 * di + v2 * dj)) * m
            cw = Coefs(aa, bb, cc, dd, None, None, level.diag_a)
            uw, res = _cascade(cw, torch.zeros_like(rw), rw,
                               (gi + gj) % 2 == 0, diag, inv, nsweeps)
            tile = (slice(by * th, (by + 1) * th),
                    slice(bx * tw, (bx + 1) * tw))
            for out, w in zip(outs, (hi2, lo2, rw, uw, res)):
                out[tile] = w[hr:hr + th, hc:hc + tw]
    hi2, lo2, rhs, u, res = (o[:rows, :cols] for o in outs)
    if rows_dec:
        res = res[::2]
    return hi2, lo2, rhs, u, res if want_residual else None


def _open_inputs(shape, seed):
    """hi, lo, d: random in every cell of the array."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(s * rng.standard_normal(shape))
            for s in (1.0, 1e-9, 1e-2)]


def _open_chain(level, hi, lo, d, nsweeps, rows_dec, calls):
    """The wrapper's schedule (`delta_step.open_in_launches`) of emulated
    launches: K8, then K2 links on its rhs."""
    opened = []

    def opening(k, last):
        calls.append(("K8", k, last))
        *pairs, u, res = _emulate_open(level, hi, lo, d, k, last, rows_dec)
        opened.extend(pairs)
        return u, res

    def link(u, corr, k, last):
        calls.append(("K2", k, last))
        return _emulate(level, u, corr, opened[2], k, last, rows_dec)

    u, res = delta_step.open_in_launches(nsweeps, opening, link)
    return (*opened, u, res)


@pytest.mark.parametrize("rows_dec", [True, False])
@pytest.mark.parametrize("kind, nsweeps", [("n64", 1), ("n64", 3),
                                           ("n64", 14), ("n128", 3)])
def test_open_windows_equal_the_plain_version(kind, nsweeps, rows_dec):
    """K8 on the 72x128 and 136x256 levels, whose ragged last tiles (no
    tile width divides 128 or 256 at nsweeps 1 or 3) hold cells past the
    array, bit for bit against `fused_open_presmooth_plain`; at nsweeps 14
    as K8 of FROM_V_MAX_SWEEPS sweeps, then one K2 link with the
    residual."""
    level = _level(kind)
    m = smoother.FROM_V_MAX_SWEEPS
    _, _, th, tw = _tile(min(nsweeps, m))
    assert level.padded[0] % th and (nsweeps > m or level.padded[1] % tw)
    hi, lo, d = _open_inputs(level.padded, seed=nsweeps)
    calls = []
    got = _open_chain(level, hi, lo, d, nsweeps, rows_dec, calls)
    want = delta_step.fused_open_presmooth_plain(level, hi, lo, d, nsweeps,
                                                 rows_dec)
    assert calls == ([("K8", nsweeps, True)] if nsweeps <= m else
                     [("K8", m, False), ("K2", nsweeps - m, True)])
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_open_window_one_row_short_fails():
    """The halo is exactly what the opening needs: one row fewer lets the
    wrong rhs at the window's edge reach the tile."""
    level = _level("n64")
    hi, lo, d = _open_inputs(level.padded, seed=3)
    got = _emulate_open(level, hi, lo, d, 3, True, False, short=1)
    want = delta_step.fused_open_presmooth_plain(level, hi, lo, d, 3)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert not all(torch.equal(g, w) for g, w in zip(got, want))
    exact = _emulate_open(level, hi, lo, d, 3, True, False)
    assert all(torch.equal(g, w) for g, w in zip(exact, want))


# ---------------------------------------------------------------------------
# The coarse tower (K3, K4) on the from_v block


def _links(nsweeps):
    """The sweeps of each link of a tower level, as csrc/tower.cu chains
    them (tower_links, link_sweeps) with the source's FV_MAX_SWEEPS."""
    m = int(re.search(r"constexpr int FV_MAX_SWEEPS = (\d+);",
                      _source()).group(1))
    links = (nsweeps - 1) // m + 1 if nsweeps > m else 1
    return [m] * (links - 1) + [nsweeps - (links - 1) * m]


def _hierarchy():
    """n=256: levels 256, 128, 64 and the dense coarse level 32."""
    vel = np.random.default_rng(7).standard_normal((2, 257, 257))
    return build_hierarchy(vel[0], vel[1], 0.1 / 256, -4e-4, 4, dtype=DT,
                           device="cpu", coarse_mode="dense")


def _inject(res, coarse_shape, nsweeps):
    """The descent's coarse rhs as the kernel writes it: each tile of the
    last link (tile size at `nsweeps`) writes res[2I, 2J] at its even
    nodes, then zero_past writes 0 to every cell whose fine node lies past
    the array.  Every coarse cell must be written exactly once."""
    rows, cols = res.shape
    rows_c, cols_c = coarse_shape
    _, _, th, tw = _tile(nsweeps)
    out = torch.full(coarse_shape, float("nan"), dtype=DT)
    writes = torch.zeros(coarse_shape, dtype=torch.int64)
    for i0 in range(0, rows, th):
        for j0 in range(0, cols, tw):
            gi = torch.arange(i0, min(i0 + th, rows))
            gj = torch.arange(j0, min(j0 + tw, cols))
            gi, gj = gi[gi % 2 == 0], gj[gj % 2 == 0]
            gi, gj = gi[gi // 2 < rows_c], gj[gj // 2 < cols_c]
            out[gi[:, None] // 2, gj[None, :] // 2] = res[gi[:, None],
                                                          gj[None, :]]
            writes[gi[:, None] // 2, gj[None, :] // 2] += 1
    r0, c0 = min((rows + 1) // 2, rows_c), min((cols + 1) // 2, cols_c)
    for at in ((slice(r0, None), slice(None)), (slice(None, r0),
                                                slice(c0, None))):
        out[at] = 0.0
        writes[at] += 1
    assert bool((writes == 1).all())
    return out


def _prolong(c, shape):
    """The ascent's prolongation as the kernel forms it at a thread's two
    columns (common.cuh::prolong_pair), for the whole fine array."""
    rows, cols = shape
    cp = F.pad(c, (0, 2, 0, 2))  # reads past the coarse array are 0
    i = torch.arange(rows)[:, None]
    I, J = i // 2, torch.arange(0, cols, 2)[None, :] // 2
    c00, c01, c10, c11 = cp[I, J], cp[I, J + 1], cp[I + 1, J], cp[I + 1,
                                                                 J + 1]
    even = i % 2 == 0
    p0 = torch.where(even, c00, 0.5 * (c00 + c10))
    p1 = torch.where(even, 0.5 * (c00 + c01), 0.5 * (p0 + 0.5 * (c01 + c11)))
    return torch.stack([p0, p1], dim=2).reshape(rows, cols)


def _emulate_tower_descend(levels, s, rhs, nsweeps):
    sub = levels[s:]
    u_mids, rhs_l = [], [rhs]
    for level, coarse in zip(sub[:-1], sub[1:]):
        links = _links(nsweeps)
        u = None
        for k, ns in enumerate(links):
            last = k == len(links) - 1
            u, res = _emulate(level, u, None, rhs_l[-1], ns, last, False)
        u_mids.append(u)
        rhs_l.append(_inject(res, coarse.padded, links[-1]))
    return u_mids, rhs_l[:-1], rhs_l[-1]


def _emulate_tower_ascend(levels, s, v, u_mids, rhs_mids, nsweeps):
    mids = levels[s:-1]
    for i in range(len(mids) - 1, -1, -1):
        corr, u = _prolong(v, mids[i].padded), u_mids[i]
        for ns in _links(nsweeps):
            u, _ = _emulate(mids[i], u, corr, rhs_mids[i], ns, False, False)
            corr = None
        v = u
    return v


TOWER_CASES = [(1, 1), (1, 3), (1, 14), (2, 3)]


@pytest.mark.parametrize("s, nsweeps", TOWER_CASES)
def test_tower_descent_tiles_equal_the_plain_version(s, nsweeps):
    """K3's schedule from level s of n=256 (s=1: levels 128 and 64 onto
    the coarse 32; nsweeps 14 chains a link of 13 and one of 1)."""
    levels = _hierarchy()
    _, _, rhs = _inputs(levels[s].padded, seed=s + nsweeps)
    got = _emulate_tower_descend(levels, s, rhs, nsweeps)
    want = tower.tower_descend_plain(levels, s, rhs, nsweeps)
    flat = lambda r: [*r[0], *r[1], r[2]]
    assert len(flat(got)) == len(flat(want)) == 2 * (3 - s) + 1
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("s, nsweeps", TOWER_CASES)
def test_tower_ascent_tiles_equal_the_plain_version(s, nsweeps):
    """K4's schedule from the coarse solution of the plain descent: the
    per-point prolongation added on load, then the (chained) cascade."""
    levels = _hierarchy()
    _, _, rhs = _inputs(levels[s].padded, seed=s + nsweeps)
    u_mids, rhs_mids, bottom = tower.tower_descend_plain(levels, s, rhs,
                                                         nsweeps)
    v = coarse_solve_dense(levels[-1], bottom)
    got = _emulate_tower_ascend(levels, s, v, u_mids, rhs_mids, nsweeps)
    want = tower.tower_ascend_plain(levels, s, v, u_mids, rhs_mids, nsweeps)
    assert torch.equal(got, want)


def test_tower_links_chain_as_the_wrapper_chains_k2():
    """A tower level chains its links as `in_launches` chains K2's
    launches: FV_MAX_SWEEPS equals the wrapper's FROM_V_MAX_SWEEPS, and
    the links' sweeps are those of in_launches' calls for every nsweeps."""
    for nsweeps in range(0, 45):
        calls = []
        smoother.in_launches(None, None, nsweeps,
                             lambda u, c, k, last: calls.append(k) or (u, c))
        assert _links(nsweeps) == calls
    assert _links(smoother.FROM_V_MAX_SWEEPS) == [smoother.FROM_V_MAX_SWEEPS]


def test_tower_outputs_are_views_of_one_allocation():
    """The wrappers allocate a launch's outputs once: aligned, contiguous
    views of the level shapes."""
    levels = _hierarchy()
    shapes = [l.padded for l in levels]
    views = tower._carve(shapes, torch.empty(0, dtype=DT))
    base = views[0].data_ptr()
    assert [tuple(v.shape) for v in views] == shapes
    assert all(v.is_contiguous() for v in views)
    assert all((v.data_ptr() - base) % (2 * DT.itemsize) == 0 for v in views)
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1
