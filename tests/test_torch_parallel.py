"""PyTorch port: the distributed run (parallel/), the counterpart of
tests/test_parallel.py and the distributed tests of tests/test_refine.py.

The ranks are spawned processes over gloo on the CPU, with a file
rendezvous in the test's temporary directory; each runs
`distributed_run` on its blocks and rank 0 hands back uT and the stats.
This module imports jax only inside the tests, so the spawned ranks
import torch and numpy alone.  The comparisons run in the test process.

Each run is keyed (config, min_local, layout); layout "auto" is the
default, which is "rows" under red–black GS.  W=2 factors to a 1x2 mesh,
so its 2-D blocks split the columns only; W=4 to 2x2, which splits both
axes and exercises the corners.  Which levels are partitioned (n=64, W
ranks, min_local):
  (a) W=2, 3 levels, min_local 32: level 0 only, the tower below it (in
      both layouts);
  (b) W=4, 3 levels, min_local 8: every level above the coarsest; in the
      2-D layout the coarsest too, which is solved on its gathered field;
  (c) the same rows run's level 1: 10-row blocks, thinner than 2h = 16,
      which take the one-row-exchange-per-colour-pass schedule;
  (d) W=4, min_local 1 (tests/test_parallel.py): the coarsest level too;
  (e) W=2, n=128, min_local 16: a model born partitioned (each rank
      builds its rows, or its 2-D window, on the device) against the whole
      device build;
  (f) W=4, 3 levels, min_local 8, in both layouts: FMG (plain and
      refined), the Jacobi and Chebyshev smoothers, and Galerkin levels,
      whose level 1 (nine-band) is partitioned.

Bounds: every distributed run equals the port's single-device run
bitwise (every op on the path is elementwise or schedule-exact; the
norms, added in another order, do not feed the iterate), in both
layouts, and the overlap schedule the plain one.  The rows runs meet the
JAX package's single-device run, the 2-D and the (f) runs its
`distributed_run` over as many devices of its CPU mesh (layout "auto",
"2d" there), at the same bounds.  Against the JAX package:
plain adaptive f64 at atol 1e-12 with equal cycle counts
(tests/test_parallel.py; measured 4.4e-16).  The delta and refined runs
solve their corrections in float32, where XLA rounds some expressions in
another order than the port, so they meet the JAX run only to a few
float32 ulps of the correction, not to the 1e-10 tests/test_refine.py
holds two JAX runs to: measured max |uT - uT_jax| 9.313e-09 (delta) and
3.725e-09 (refined, adaptive and fixed), the same for the port's
single-device runs; the bounds sit just above, at 1e-8 and 5e-9.  The
float64 runs of (f) at 1e-12, FMG refined at 5e-9, with equal cycle
counts.
"""

import functools

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.parallel import (
    GridBlocks,
    Mesh,
    RowBlocks,
    distributed_run,
    factor_2d,
    launch_local,
    level_shardings_for_ns,
    make_mesh,
    resolve_layout,
)

_DELTA = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
              delta_form=True, num_levels=3, certify_every=2)
# name: (problem, solver keywords; dtypes as names, for the JAX side too)
CONFIGS = {
    "delta": (dict(n=64, num_steps=5),
              dict(_DELTA, dtype="float32", refine_dtype="float64")),
    "delta_overlap": (dict(n=64, num_steps=5),
                      dict(_DELTA, dtype="float32", refine_dtype="float64",
                           sharded_overlap=True)),
    "adaptive_f64": (dict(n=64, num_steps=10), dict(dtype="float64")),
    "refined_adaptive": (dict(n=64, num_steps=5),
                         dict(dtype="float32", refine_dtype="float64",
                              tol=1e-6)),
    "refined_fixed": (dict(n=64, num_steps=5),
                      dict(dtype="float32", refine_dtype="float64", tol=1e-6,
                           cycle_mode="fixed", num_cycles=1,
                           coarse_mode="dense")),
    "delta_device": (dict(n=128, num_steps=3),
                     dict(_DELTA, dtype="float32", refine_dtype="float64",
                          device_build=True)),
    "fmg": (dict(n=64, num_steps=3),
            dict(dtype="float64", cycle_mode="fmg", num_cycles=1,
                 num_levels=3)),
    "fmg_refined": (dict(n=64, num_steps=3),
                    dict(dtype="float32", refine_dtype="float64", tol=1e-6,
                         cycle_mode="fmg", num_cycles=1, num_levels=3)),
    "jacobi": (dict(n=64, num_steps=3),
               dict(dtype="float64", smoother="jacobi", jacobi_omega=0.8,
                    num_levels=3)),
    "chebyshev": (dict(n=64, num_steps=3),
                  dict(dtype="float64", smoother="chebyshev", num_levels=3)),
    "galerkin": (dict(n=64, num_steps=3),
                 dict(dtype="float64", coarse_operator="galerkin",
                      num_levels=3)),
}
# n=32, 3-step forms of five of them, for the captured partitioned runs of
# tests/test_torch_partitioned_compiled.py
CONFIGS.update({f"{name}_32": (dict(n=32, num_steps=3), CONFIGS[name][1])
                for name in ("delta", "delta_overlap", "adaptive_f64", "fmg",
                             "jacobi")})
# the configurations the port ran on one device only until the 2-D
# layout: each runs at W=4, min_local 8, in both layouts; the bound
# against the JAX package's run
NEW = {"fmg": 1e-12, "fmg_refined": 5e-9, "jacobi": 1e-12,
       "chebyshev": 1e-12, "galerkin": 1e-12}
# a job "born <config>" builds the model born partitioned over the
# spawn's ranks (AdvectionDiffusion(mesh=...)) and runs it as built
# world: the (config, min_local, layout) runs of one spawn
RUNS = {
    2: [(name, ml, layout) for layout in ("auto", "2d") for name, ml in (
        ("delta", 32), ("delta_overlap", 32), ("refined_adaptive", 8),
        ("refined_fixed", 8), ("delta_device", 16),
        ("born delta_device", 16))] + [("adaptive_f64", 8, "auto")],
    4: [(name, ml, layout) for layout in ("auto", "2d") for name, ml in (
        ("delta", 8), ("delta_overlap", 8), ("adaptive_f64", 1))]
       + [(name, 8, layout) for name in NEW for layout in ("rows", "2d")],
}


def _solver(kw, lib):
    """SolverConfig keywords with dtype names resolved in `lib` (torch or
    jax.numpy)."""
    return {k: getattr(lib, v) if k in ("dtype", "refine_dtype") else v
            for k, v in kw.items()}


def _port_model(name, **kw):
    p, s = CONFIGS[name]
    return AdvectionDiffusion(ProblemConfig(**p),
                              SolverConfig(**_solver(s, torch)), device="cpu",
                              **kw)


def _refused(run) -> bool:
    try:
        run()
    except ValueError:
        return True
    return False


def rank_runs(jobs):
    """One rank: each (config, min_local, layout) run through
    distributed_run; a born job also records whether another mesh and
    another min_local were refused."""
    torch.set_num_threads(1)
    out, models = {}, {}
    for name, min_local, layout in jobs:
        if name.startswith("born "):
            mesh = make_mesh()
            model = _port_model(name[5:], mesh=mesh, min_local=min_local,
                                layout=layout)
            out["refused", name, layout] = (
                _refused(lambda: distributed_run(
                    model, Mesh(mesh.world, (mesh.rank + 1) % mesh.world))),
                _refused(lambda: distributed_run(model,
                                                 min_local=2 * min_local)))
            uT, stats = distributed_run(model)
        else:
            # built once a rank: distributed_run leaves the model as it is
            if name not in models:
                models[name] = _port_model(name)
            uT, stats = distributed_run(models[name], min_local=min_local,
                                        layout=layout)
        out[name, min_local, layout] = (
            uT.numpy(), {k: v.numpy() for k, v in stats.items()})
    return out


@pytest.fixture(scope="module")
def spawned():
    """{world: {(config, min_local, layout): (uT, stats)}} from one spawn
    per world size."""
    return {w: launch_local(rank_runs, w, (jobs,))
            for w, jobs in RUNS.items()}


@functools.cache
def _single(name):
    """The port's single-device run of a configuration."""
    uT, stats = _port_model(name).run(warn=False)
    return uT.numpy(), {k: v.numpy() for k, v in stats.items()}


def _jax_model(name):
    import jax.numpy as jnp

    from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
    from hpcclassmultigridproject_tpu import SolverConfig as JSolver
    from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel

    p, s = CONFIGS[name]
    s = {k: v for k, v in s.items() if k != "sharded_overlap"}
    return JModel(JProblem(**p), JSolver(**_solver(s, jnp)))


@functools.cache
def _jax_single(name):
    """The JAX package's single-device run (CPU, x64)."""
    uT, stats = _jax_model(name).run(warn=False)
    return np.asarray(uT), {k: np.asarray(v) for k, v in stats.items()}


@functools.cache
def _jax_dist(name, world, min_local):
    """The JAX package's distributed_run over `world` devices of its CPU
    mesh, in its layout "auto" ("2d" off the TPU)."""
    import jax

    from hpcclassmultigridproject_tpu.parallel import (
        distributed_run as j_run,
        make_mesh as j_mesh,
    )

    uT, stats = j_run(_jax_model(name), j_mesh(jax.devices()[:world]),
                      min_local=min_local)
    return np.asarray(uT), {k: np.asarray(v) for k, v in stats.items()}


def _check_run(spawned, world, name, min_local, layout, bound):
    """A spawned run: bitwise the port's single-device run, within `bound`
    of the JAX package's (its distributed_run for a 2-D or a new
    configuration's run, else its single device), equal cycle counts and
    the same stats keys."""
    uT, stats = spawned[world][name, min_local, layout]
    uT1, stats1 = _single(name)
    assert np.array_equal(uT, uT1), np.abs(uT - uT1).max()
    if layout == "2d" or name in NEW:
        juT, jstats = _jax_dist(name, world, min_local)
    else:
        juT, jstats = _jax_single(name)
    np.testing.assert_allclose(uT, juT, rtol=0, atol=bound)
    np.testing.assert_array_equal(stats["cycles"], jstats["cycles"])
    assert set(stats) == set(stats1)
    return stats


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_factor_2d_matches_jax():
    from hpcclassmultigridproject_tpu.parallel import factor_2d as j_factor

    for n in range(1, 33):
        assert factor_2d(n) == j_factor(n)


def test_make_mesh_without_a_process_group():
    mesh = make_mesh()
    assert (mesh.world, mesh.rank, mesh.shape, mesh.backend) == (
        1, 0, (1, 1), None)
    assert Mesh(8, 3).shape == (2, 4)
    with pytest.raises(ValueError):
        Mesh(4, 4)


def test_collective_over_a_view_without_a_process_group_raises():
    """A mesh of several ranks built by hand (another rank's view) runs
    the per-block code, but a collective over it raises instead of
    returning this rank's part; on one rank the collectives are the
    identity."""
    from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
        all_gather_rows,
        all_sum,
    )

    x = torch.arange(6.0).reshape(2, 3)
    with pytest.raises(RuntimeError, match="process group"):
        all_sum(x.sum(), Mesh(2, 1))
    with pytest.raises(RuntimeError, match="process group"):
        all_gather_rows(x, Mesh(4, 0))
    assert float(all_sum(x.sum(), Mesh(1))) == 15.0
    assert torch.equal(all_gather_rows(x, make_mesh()), x)


def test_partitioned_levels_match_jax():
    """The JAX agglomeration rule over a grid of (ns, W, min_local), and
    the nesting: each coarser block is half its finer one, every block
    starts at an even row, and the blocks cover the logical grid."""
    import jax

    from hpcclassmultigridproject_tpu.parallel import make_mesh as j_mesh
    from hpcclassmultigridproject_tpu.parallel.sharding import (
        level_shardings_for_ns as j_shardings,
    )

    for n in (64, 256, 1024):
        for levels in (1, 3, int(np.log2(n)) - 4):
            ns = [n >> lvl for lvl in range(levels)]
            for world in (1, 2, 4, 8):
                jm = j_mesh(jax.devices()[:world])
                for min_local in (1, 8, 32, 64):
                    want = [len(s.spec) > 0 for s in
                            j_shardings(ns, jm, min_local, layout="rows")]
                    got = level_shardings_for_ns(ns, Mesh(world), min_local)
                    assert [p is not None for p in got] == want
                    parts = [p for p in got if p is not None]
                    for lvl, p in enumerate(parts):
                        assert p.local % 2 == 0
                        assert p.span >= ns[lvl] + 1
                        if lvl:
                            assert 2 * p.local == parts[lvl - 1].local


def test_grid_partitioned_levels_match_jax():
    """The 2-D layout: the JAX agglomeration rule of
    `level_shardings_for_ns(..., layout="2d")` over a grid of (ns, W,
    min_local), and the nesting on both axes: each coarser block is half
    its finer one, every block starts at an even row and column, and the
    blocks cover the logical grid."""
    import jax

    from hpcclassmultigridproject_tpu.parallel import make_mesh as j_mesh
    from hpcclassmultigridproject_tpu.parallel.sharding import (
        level_shardings_for_ns as j_shardings,
    )

    for n in (64, 256, 1024):
        for levels in (1, 3, int(np.log2(n)) - 4):
            ns = [n >> lvl for lvl in range(levels)]
            for world in (1, 2, 4, 8):
                jm = j_mesh(jax.devices()[:world])
                for min_local in (1, 8, 32, 64):
                    want = [len(s.spec) > 0 for s in
                            j_shardings(ns, jm, min_local, layout="2d")]
                    got = level_shardings_for_ns(ns, Mesh(world), min_local,
                                                 layout="2d")
                    assert [p is not None for p in got] == want
                    parts = [p for p in got if p is not None]
                    for lvl, p in enumerate(parts):
                        assert isinstance(p, GridBlocks)
                        assert p.local % 2 == 0 and p.local_cols % 2 == 0
                        assert p.span >= ns[lvl] + 1
                        assert p.col_span >= ns[lvl] + 1
                        if lvl:
                            assert 2 * p.local == parts[lvl - 1].local
                            assert (2 * p.local_cols
                                    == parts[lvl - 1].local_cols)


def test_mesh_coordinates_and_neighbors():
    """Rank k at (k // cols, k % cols) of factor_2d's shape, as the JAX
    package's make_mesh reshapes its devices; neighbours None past the
    edges."""
    import jax

    from hpcclassmultigridproject_tpu.parallel import make_mesh as j_mesh

    for world in (1, 2, 4, 6, 8):
        devices = j_mesh(jax.devices()[:world]).devices
        for rank in range(world):
            mesh = Mesh(world, rank)
            i, j = mesh.coords
            assert devices[i, j] == jax.devices()[rank]
            up, down, left, right = mesh.neighbors
            rows, cols = mesh.shape
            assert up == (rank - cols if i else None)
            assert down == (rank + cols if i < rows - 1 else None)
            assert left == (rank - 1 if j else None)
            assert right == (rank + 1 if j < cols - 1 else None)
    assert Mesh.axis_names == ("x", "y")


def test_auto_layout_is_rows_for_rbgs_and_2d_otherwise():
    """`layout="auto"`: "rows" where K7 smooths the partitioned levels
    (red–black GS), "2d" for Jacobi and Chebyshev, in distributed_run and
    in a model born partitioned."""
    for smoother, want in (("rbgs", "rows"), ("jacobi", "2d"),
                           ("chebyshev", "2d")):
        cfg = SolverConfig(dtype=torch.float64, smoother=smoother,
                           device_build=True)
        assert resolve_layout("auto", cfg) == want
        assert resolve_layout("rows", cfg) == "rows"
        model = AdvectionDiffusion(ProblemConfig(n=64, num_steps=1), cfg,
                                   device="cpu", mesh=Mesh(4, 1), min_local=8)
        assert model.layout == want
        kind = RowBlocks if want == "rows" else GridBlocks
        assert isinstance(model.shardings[0], kind)


@pytest.mark.parametrize("world,min_local", [(2, 32), (4, 8)])
def test_delta_form_matches_single_device(spawned, world, min_local):
    """(a), (b), (c): bitwise against the port's single-device run, atol
    1e-8 against the JAX package's (measured 9.313e-09); every certificate
    <= 1e-6."""
    uT, stats = spawned[world]["delta", min_local, "auto"]
    uT1, stats1 = _single("delta")
    juT, _ = _jax_single("delta")
    assert np.array_equal(uT, uT1), np.abs(uT - uT1).max()
    np.testing.assert_allclose(uT, juT, rtol=0, atol=1e-8)
    assert set(stats) == set(stats1)
    assert float(stats["final_rel_residual_hi"]) <= 1e-6
    assert (stats["rel_residual"] <= 1e-6).all()
    hi = stats["rel_residual_hi_steps"]
    assert (hi[hi >= 0] <= 1e-6).all()
    np.testing.assert_array_equal(hi < 0, stats1["rel_residual_hi_steps"] < 0)
    np.testing.assert_allclose(stats["rel_residual"], stats1["rel_residual"],
                               rtol=1e-4)


@pytest.mark.parametrize("world,min_local", [(2, 32), (4, 8)])
def test_delta_form_2d_matches_single_device_and_jax(spawned, world,
                                                     min_local):
    """(a), (b) in the 2-D layout: bitwise the port's single-device run,
    within 1e-8 of the JAX package's distributed_run ("2d" on its CPU
    mesh), every certificate <= 1e-6."""
    stats = _check_run(spawned, world, "delta", min_local, "2d", 1e-8)
    assert float(stats["final_rel_residual_hi"]) <= 1e-6
    assert (stats["rel_residual"] <= 1e-6).all()
    hi = stats["rel_residual_hi_steps"]
    assert (hi >= 0).sum() == 2 and (hi[hi >= 0] <= 1e-6).all()


@pytest.mark.parametrize("world,min_local", [(2, 8), (4, 1)])
def test_plain_adaptive_f64_matches_jax(spawned, world, min_local):
    """tests/test_parallel.py's run (default solver in f64, 10 steps); at
    W=4 and min_local 1 the coarsest level is partitioned (d)."""
    uT, stats = spawned[world]["adaptive_f64", min_local, "auto"]
    juT, jstats = _jax_single("adaptive_f64")
    np.testing.assert_allclose(uT, juT, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(stats["cycles"], jstats["cycles"])
    np.testing.assert_array_equal(uT, _single("adaptive_f64")[0])


def test_plain_adaptive_f64_2d_matches_jax(spawned):
    """(d) in the 2-D layout: W=4, min_local 1, every level partitioned
    (the coarsest solved on its gathered field); the JAX package's
    distributed_run at atol 1e-12 with equal cycle counts."""
    _check_run(spawned, 4, "adaptive_f64", 1, "2d", 1e-12)


@pytest.mark.parametrize("name", ["refined_adaptive", "refined_fixed"])
def test_refined_matches_jax(spawned, name):
    """tests/test_refine.py's distributed refined runs, adaptive and the
    fixed flagship form (measured max |uT - uT_jax| 3.725e-09)."""
    uT, stats = spawned[2][name, 8, "auto"]
    juT, jstats = _jax_single(name)
    np.testing.assert_allclose(uT, juT, rtol=0, atol=5e-9)
    np.testing.assert_array_equal(stats["cycles"], jstats["cycles"])
    assert (stats["rel_residual"] <= 1e-6).all()
    np.testing.assert_array_equal(uT, _single(name)[0])


@pytest.mark.parametrize("name", ["refined_adaptive", "refined_fixed"])
def test_refined_2d_matches_jax(spawned, name):
    """The refined runs over W=2 in the 2-D layout (level 0 split by
    columns): bitwise the single-device run, within 5e-9 of the JAX
    package's distributed_run, every step certified."""
    stats = _check_run(spawned, 2, name, 8, "2d", 5e-9)
    assert (stats["rel_residual"] <= 1e-6).all()


@pytest.mark.parametrize("layout", ["auto", "2d"])
def test_born_partitioned_run_matches_the_whole_build(spawned, layout):
    """W=2, n=128, min_local 16, 3 delta steps: the model born partitioned
    (each rank built its rows, or its 2-D window, only) against
    distributed_run of the whole device-built model in the same layout, at
    the JAX package's bound (tests/test_levels_device.py: rtol 2e-6 / atol
    1e-11; on the CPU a window may round sin differently from the whole
    build); every certificate <= 1e-6; another mesh and another min_local
    refused."""
    born, stats = spawned[2]["born delta_device", 16, layout]
    whole, _ = spawned[2]["delta_device", 16, layout]
    np.testing.assert_allclose(born, whole, rtol=2e-6, atol=1e-11)
    assert float(stats["final_rel_residual_hi"]) <= 1e-6
    assert (stats["rel_residual"] <= 1e-6).all()
    hi = stats["rel_residual_hi_steps"]
    assert (hi >= 0).sum() == 1 and (hi[hi >= 0] <= 1e-6).all()
    assert spawned[2]["refused", "born delta_device", layout] == (True, True)


@pytest.mark.parametrize("world,min_local", [(2, 32), (4, 8)])
def test_overlap_schedule_equals_plain(spawned, world, min_local):
    plain, _ = spawned[world]["delta", min_local, "auto"]
    over, _ = spawned[world]["delta_overlap", min_local, "auto"]
    assert np.array_equal(over, plain)


@pytest.mark.parametrize("world,min_local", [(2, 32), (4, 8)])
def test_overlapped_halo_sweep_equals_plain_2d(spawned, world, min_local):
    """`sharded_overlap` in the 2-D layout picks halo.py's overlapped
    sweep: the same bits as the plain one."""
    plain, _ = spawned[world]["delta", min_local, "2d"]
    over, _ = spawned[world]["delta_overlap", min_local, "2d"]
    assert np.array_equal(over, plain)


def test_one_rank_equals_single_device():
    """W=1 (no process group): nothing is partitioned, and the run is the
    single-device run to the bit."""
    uT, stats = distributed_run(_port_model("delta"), make_mesh())
    uT1, stats1 = _single("delta")
    assert np.array_equal(uT.numpy(), uT1)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), stats1[k])


def test_layout_2d_runs_and_matches(spawned):
    """The 2-D layout is the JAX package's: its partitioned levels over a
    hand-built 1x2 mesh are GridBlocks of half the padded columns each,
    and the W=2 run in it equals the port's single-device run to the bit
    (min_local 32: level 0 split by columns)."""
    got = level_shardings_for_ns([64, 32], Mesh(2), min_local=32,
                                 layout="2d")
    assert got[1] is None and isinstance(got[0], GridBlocks)
    assert (got[0].shape, got[0].col_start, Mesh(2, 1).coords) == (
        (72, 64), 0, (0, 1))
    uT, _ = spawned[2]["delta", 32, "2d"]
    assert np.array_equal(uT, _single("delta")[0])


def test_born_sharded_model_builds_its_blocks():
    """A mesh builds the model born partitioned (the device build): rank
    0 of two holds its blocks, with the shardings that distributed_run
    would choose; in the 2-D layout, rank 1's window of rows and
    columns."""
    p, s = CONFIGS["delta"]
    model = AdvectionDiffusion(ProblemConfig(**p),
                               SolverConfig(**_solver(s, torch)), device="cpu",
                               mesh=Mesh(2), min_local=16)
    assert model.shardings == level_shardings_for_ns(
        [level.n for level in model.levels], Mesh(2), 16)
    part = model.shardings[0]
    assert model.u0.shape == part.shape
    assert model.levels[0].padded[0] == part.local + 2 * part.halo
    grid = AdvectionDiffusion(ProblemConfig(**p),
                              SolverConfig(**_solver(s, torch)), device="cpu",
                              mesh=Mesh(2, 1), min_local=16, layout="2d")
    part = grid.shardings[0]
    assert grid.u0.shape == part.shape == (72, 64)
    level = grid.levels[0]
    assert (level.row_off, level.col_off) == (-1, 63)
    assert level.padded == (74, 66)


@pytest.mark.parametrize("name", ["fmg", "fmg_refined"])
def test_fmg_under_a_mesh_runs_and_matches(spawned, name):
    """(f): FMG, plain and refined, over W=4 in both layouts: bitwise the
    port's single-device run, within the bound of the JAX package's
    distributed_run, equal cycle counts."""
    for layout in ("rows", "2d"):
        _check_run(spawned, 4, name, 8, layout, NEW[name])


def test_galerkin_under_a_mesh_runs_and_matches(spawned):
    """(f): Galerkin levels over W=4 (n=64, min_local 8), level 1
    nine-band and partitioned, in both layouts: bitwise the single-device
    run, within 1e-12 of the JAX package's distributed_run."""
    shardings = level_shardings_for_ns([64, 32, 16], Mesh(4), 8)
    assert shardings[1] is not None
    for layout in ("rows", "2d"):
        _check_run(spawned, 4, "galerkin", 8, layout, 1e-12)


@pytest.mark.parametrize("layout", ["rows", "2d"])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_partitioned_smoother_runs_and_matches(spawned, smoother, layout):
    """(f): the Jacobi and Chebyshev smoothers over partitioned levels
    (W=4, min_local 8), in both layouts: bitwise the single-device run
    (Chebyshev's Gershgorin bound is a max over the ranks), within 1e-12
    of the JAX package's distributed_run, equal cycle counts."""
    _check_run(spawned, 4, smoother, 8, layout, 1e-12)
