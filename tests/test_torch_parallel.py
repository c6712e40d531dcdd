"""PyTorch port: the distributed run (parallel/), the counterpart of
tests/test_parallel.py and the distributed tests of tests/test_refine.py.

The ranks are spawned processes over gloo on the CPU, with a file
rendezvous in the test's temporary directory; each runs
`distributed_run` on its blocks and rank 0 hands back uT and the stats.
This module imports jax only inside the tests, so the spawned ranks
import torch and numpy alone.  The comparisons run in the test process.

Which levels are partitioned (n=64, W ranks, min_local):
  (a) W=2, 3 levels, min_local 32: level 0 only, the tower below it;
  (b) W=4, 3 levels, min_local 8: every level above the coarsest;
  (c) the same run's level 1: 10-row blocks, thinner than 2h = 16, which
      take the one-row-exchange-per-colour-pass schedule;
  (d) W=4, min_local 1 (tests/test_parallel.py): the coarsest level too;
  (e) W=2, n=128, min_local 16: a model born row-partitioned (each rank
      builds its rows on the device) against the whole device build.

Bounds: every distributed run equals the port's single-device run
bitwise (every op on the path is elementwise or schedule-exact; the
norms, added in another order, do not feed the iterate), and the overlap
schedule the plain one.  Against the JAX package's single-device run:
plain adaptive f64 at atol 1e-12 with equal cycle counts
(tests/test_parallel.py; measured 4.4e-16).  The delta and refined runs
solve their corrections in float32, where XLA rounds some expressions in
another order than the port, so they meet the JAX run only to a few
float32 ulps of the correction, not to the 1e-10 tests/test_refine.py
holds two JAX runs to: measured max |uT - uT_jax| 9.313e-09 (delta) and
3.725e-09 (refined, adaptive and fixed), the same for the port's
single-device runs; the bounds sit just above, at 1e-8 and 5e-9.
"""

import functools

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.parallel import (
    Mesh,
    distributed_run,
    factor_2d,
    launch_local,
    level_shardings_for_ns,
    make_mesh,
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
}
# a job "born <config>" builds the model born row-partitioned over the
# spawn's ranks (AdvectionDiffusion(mesh=...)) and runs it as built
# world: the (config, min_local) runs of one spawn
RUNS = {
    2: [("delta", 32), ("delta_overlap", 32), ("adaptive_f64", 8),
        ("refined_adaptive", 8), ("refined_fixed", 8), ("delta_device", 16),
        ("born delta_device", 16)],
    4: [("delta", 8), ("delta_overlap", 8), ("adaptive_f64", 1)],
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
    """One rank: each (config, min_local) run through distributed_run; a
    born job also records whether another mesh and another min_local
    were refused."""
    torch.set_num_threads(1)
    out = {}
    for name, min_local in jobs:
        if name.startswith("born "):
            mesh = make_mesh()
            model = _port_model(name[5:], mesh=mesh, min_local=min_local)
            out["refused", name] = (
                _refused(lambda: distributed_run(
                    model, Mesh(mesh.world, (mesh.rank + 1) % mesh.world))),
                _refused(lambda: distributed_run(model,
                                                 min_local=2 * min_local)))
            uT, stats = distributed_run(model)
        else:
            uT, stats = distributed_run(_port_model(name),
                                        min_local=min_local)
        out[name, min_local] = (uT.numpy(),
                                {k: v.numpy() for k, v in stats.items()})
    return out


@pytest.fixture(scope="module")
def spawned():
    """{world: {(config, min_local): (uT, stats)}} from one spawn per
    world size."""
    return {w: launch_local(rank_runs, w, (jobs,))
            for w, jobs in RUNS.items()}


@functools.cache
def _single(name):
    """The port's single-device run of a configuration."""
    uT, stats = _port_model(name).run(warn=False)
    return uT.numpy(), {k: v.numpy() for k, v in stats.items()}


@functools.cache
def _jax_single(name):
    """The JAX package's single-device run (CPU, x64)."""
    import jax.numpy as jnp

    from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
    from hpcclassmultigridproject_tpu import SolverConfig as JSolver
    from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel

    p, s = CONFIGS[name]
    s = {k: v for k, v in s.items() if k != "sharded_overlap"}
    uT, stats = JModel(JProblem(**p), JSolver(**_solver(s, jnp))).run(
        warn=False)
    return np.asarray(uT), {k: np.asarray(v) for k, v in stats.items()}


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


@pytest.mark.parametrize("world,min_local", [(2, 32), (4, 8)])
def test_delta_form_matches_single_device(spawned, world, min_local):
    """(a), (b), (c): bitwise against the port's single-device run, atol
    1e-8 against the JAX package's (measured 9.313e-09); every certificate
    <= 1e-6."""
    uT, stats = spawned[world]["delta", min_local]
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


@pytest.mark.parametrize("world,min_local", [(2, 8), (4, 1)])
def test_plain_adaptive_f64_matches_jax(spawned, world, min_local):
    """tests/test_parallel.py's run (default solver in f64, 10 steps); at
    W=4 and min_local 1 the coarsest level is partitioned (d)."""
    uT, stats = spawned[world]["adaptive_f64", min_local]
    juT, jstats = _jax_single("adaptive_f64")
    np.testing.assert_allclose(uT, juT, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(stats["cycles"], jstats["cycles"])
    np.testing.assert_array_equal(uT, _single("adaptive_f64")[0])


@pytest.mark.parametrize("name", ["refined_adaptive", "refined_fixed"])
def test_refined_matches_jax(spawned, name):
    """tests/test_refine.py's distributed refined runs, adaptive and the
    fixed flagship form (measured max |uT - uT_jax| 3.725e-09)."""
    uT, stats = spawned[2][name, 8]
    juT, jstats = _jax_single(name)
    np.testing.assert_allclose(uT, juT, rtol=0, atol=5e-9)
    np.testing.assert_array_equal(stats["cycles"], jstats["cycles"])
    assert (stats["rel_residual"] <= 1e-6).all()
    np.testing.assert_array_equal(uT, _single(name)[0])


def test_born_partitioned_run_matches_the_whole_build(spawned):
    """W=2, n=128, min_local 16, 3 delta steps: the model born
    row-partitioned (each rank built its rows only) against
    distributed_run of the whole device-built model, at the JAX package's
    bound (tests/test_levels_device.py: rtol 2e-6 / atol 1e-11; on the CPU
    a row window may round sin differently from the whole build); every
    certificate <= 1e-6; another mesh and another min_local refused."""
    born, stats = spawned[2]["born delta_device", 16]
    whole, _ = spawned[2]["delta_device", 16]
    np.testing.assert_allclose(born, whole, rtol=2e-6, atol=1e-11)
    assert float(stats["final_rel_residual_hi"]) <= 1e-6
    assert (stats["rel_residual"] <= 1e-6).all()
    hi = stats["rel_residual_hi_steps"]
    assert (hi >= 0).sum() == 1 and (hi[hi >= 0] <= 1e-6).all()
    assert spawned[2]["refused", "born delta_device"] == (True, True)


@pytest.mark.parametrize("world,min_local", [(2, 32), (4, 8)])
def test_overlap_schedule_equals_plain(spawned, world, min_local):
    plain, _ = spawned[world]["delta", min_local]
    over, _ = spawned[world]["delta_overlap", min_local]
    assert np.array_equal(over, plain)


def test_one_rank_equals_single_device():
    """W=1 (no process group): nothing is partitioned, and the run is the
    single-device run to the bit."""
    uT, stats = distributed_run(_port_model("delta"), make_mesh())
    uT1, stats1 = _single("delta")
    assert np.array_equal(uT.numpy(), uT1)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), stats1[k])


def test_layout_2d_raises_naming_the_rest_of_parallel():
    with pytest.raises(NotImplementedError, match="the rest of parallel/"):
        distributed_run(_port_model("delta"), Mesh(2), layout="2d")
    with pytest.raises(NotImplementedError, match="the rest of parallel/"):
        level_shardings_for_ns([64, 32], Mesh(2), layout="2d")


def test_born_sharded_model_builds_its_blocks():
    """A mesh now builds the model born row-partitioned (the device
    build): rank 0 of two holds its blocks, with the shardings that
    distributed_run would choose."""
    p, s = CONFIGS["delta"]
    model = AdvectionDiffusion(ProblemConfig(**p),
                               SolverConfig(**_solver(s, torch)), device="cpu",
                               mesh=Mesh(2), min_local=16)
    assert model.shardings == level_shardings_for_ns(
        [level.n for level in model.levels], Mesh(2), 16)
    part = model.shardings[0]
    assert model.u0.shape == part.shape
    assert model.levels[0].padded[0] == part.local + 2 * part.halo


def test_fmg_under_a_mesh_raises_naming_the_rest_of_parallel():
    """cycle_mode 'fmg' over a partitioned level, plain or refined, is
    refused before any collective; so is fmg_solve given shardings."""
    from hpcclassmultigridproject_tpu_torch.mg.cycle import fmg_solve

    for refine in (None, torch.float64):
        model = AdvectionDiffusion(
            ProblemConfig(n=64, num_steps=1),
            SolverConfig(dtype=torch.float64, cycle_mode="fmg",
                         refine_dtype=refine, num_cycles=1), device="cpu")
        with pytest.raises(NotImplementedError, match="the rest of parallel/"):
            distributed_run(model, Mesh(2), min_local=8)
    shardings = level_shardings_for_ns([lvl.n for lvl in model.levels],
                                       Mesh(2), min_local=8)
    with pytest.raises(NotImplementedError, match="the rest of parallel/"):
        fmg_solve(model.levels, model.u0, model.u0, model.solver, shardings)


def test_galerkin_under_a_mesh_raises_naming_the_rest_of_parallel():
    model = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=1),
        SolverConfig(dtype=torch.float64, coarse_operator="galerkin"),
        device="cpu")
    with pytest.raises(NotImplementedError, match="the rest of parallel/"):
        distributed_run(model, Mesh(2), min_local=8)
