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
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    mg_smooth9 (K5, K6: the coefficient source a compile-time variant) and
    the tower's two kernels (K3, K4), each in one cooperative launch; only
    K8 instantiates smooth_tile."""
    smoother_cu = (_build.CSRC / "smoother.cu").read_text()
    body = smoother_cu[smoother_cu.index("int smooth(const T* u"):
                       smoother_cu.index("int smooth5(")]
    assert "launch_smooth_from_v(" in body
    assert "smooth_v_kernel<T, mg::FV_PAIRED>" in body
    assert "smooth_v_kernel<T, mg::FV_SINGLES>" in body
    assert "smooth_tile" not in body and "FORM_FROM_V" not in body
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
    assert "smooth_tile" not in smoother_cu
    tile = _tile_block()
    assert "FORM_FIVE" not in tile and "FORM_NINE" not in tile
    tower_cu = (_build.CSRC / "tower.cu").read_text()
    assert "mg::smooth_from_v<T, ACCESS, XFER>(" in tower_cu
    assert "run_link<T, ACCESS, mg::FV_INJECT>" in tower_cu
    assert "run_link<T, ACCESS, mg::FV_PROLONG>" in tower_cu
    assert "cudaLaunchCooperativeKernel(" in tower_cu
    assert "<<<" not in tower_cu and "smooth_tile" not in tower_cu
    delta_cu = (_build.CSRC / "delta_step.cu").read_text()
    assert "mg::smooth_tile<T>(a);" in delta_cu
    assert "smooth_from_v" not in delta_cu


def _tile_block():
    """common.cuh's smooth_tile (K8's block), from its definition to the
    end of its launcher."""
    source = _source()
    start = source.index("__device__ void smooth_tile(")
    return source[start:source.index("cudaError_t launch_smooth(", start)]


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
