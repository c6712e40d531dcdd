"""PyTorch port: `utils/` (io, timing, checkpoint, profiling) on the CPU,
against the JAX package's `utils/` where both have the function.

Checkpointed runs are held to straight runs at atol 1e-14 in float64
(tests/test_utils_cli.py's bound), and a checkpoint directory written by
either package resumes in the other to atol 1e-12 (the f64 run bound of
tests/test_golden.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu.utils import (
    CheckpointManager as JCheckpointManager,
)
from hpcclassmultigridproject_tpu.utils import (
    run_with_checkpoints as j_run_with_checkpoints,
)
from hpcclassmultigridproject_tpu.utils import time_run as j_time_run
from hpcclassmultigridproject_tpu.utils.profiling import (
    _phase_counts as j_phase_counts,
)
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.utils import (
    CheckpointManager,
    Timer,
    device_sync,
    field_difference_norm,
    load_field,
    load_field_txt,
    run_with_checkpoints,
    save_field,
    save_field_txt,
    time_run,
)
from hpcclassmultigridproject_tpu_torch.utils import profiling

N, STEPS = 32, 8
# the JAX package's per-phase record keys (utils/profiling.py)
RECORD_KEYS = {"phase", "level", "n", "best_ms", "gdof_s", "model_gb",
               "achieved_gb_s", "model_gflop", "achieved_gflop_s"}
PHASES = {"smooth", "residual", "restrict", "prolong", "coarse", "rhs",
          "norm"}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _models(steps=STEPS, **kw):
    kw = dict(num_levels=3, **kw)
    jm = JModel(JProblem(n=N, num_steps=steps),
                JSolver(dtype=jnp.float64, **kw))
    tm = AdvectionDiffusion(ProblemConfig(n=N, num_steps=steps),
                            SolverConfig(dtype=torch.float64, **kw),
                            device="cpu")
    return jm, tm


def test_field_io_roundtrip(tmp_path):
    f = torch.from_numpy(np.random.default_rng(0).random((17, 17)))
    save_field_txt(tmp_path / "uT.txt", f)
    back = load_field_txt(tmp_path / "uT.txt")
    np.testing.assert_allclose(back, f.numpy(), atol=1e-6)  # %f: 6 places
    save_field(tmp_path / "uT.npy", f)
    assert np.array_equal(load_field(tmp_path / "uT.npy"), f.numpy())
    assert field_difference_norm(f, f.numpy()) == 0.0
    assert field_difference_norm(f, f + 1.0) == pytest.approx(17.0)


def test_time_run_keys_match_jax():
    x = torch.ones(4)
    got = time_run(lambda: x * 2.0, reps=2)
    want = j_time_run(lambda: jnp.ones(4) * 2.0, reps=2)
    assert set(got) == set(want) == {"best_s", "mean_s", "times", "out"}
    assert len(got["times"]) == 2 and got["best_s"] > 0
    assert torch.equal(got["out"], x * 2.0)
    with Timer() as t:
        device_sync((x, {"k": x}))
    assert t.seconds >= 0


def test_checkpoint_manager_prune_and_mismatch(tmp_path):
    p = ProblemConfig(n=64, num_steps=10)
    mgr = CheckpointManager(tmp_path / "ck", p, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, torch.zeros((65, 65)))
    assert mgr.steps() == [3, 4]
    step, u = mgr.load_latest()
    assert step == 4 and u.shape == (65, 65)
    with pytest.raises(ValueError, match="different problem config"):
        CheckpointManager(tmp_path / "ck", ProblemConfig(n=128, num_steps=10))
    assert CheckpointManager(tmp_path / "empty").load_latest() is None


def test_problem_config_manifest_matches_jax():
    assert (dataclasses.asdict(ProblemConfig(n=N, num_steps=STEPS))
            == dataclasses.asdict(JProblem(n=N, num_steps=STEPS)))


@pytest.mark.parametrize("kw", [
    dict(),                                           # adaptive
    dict(refine_dtype=torch.float64, cycle_mode="fixed", num_cycles=1,
         coarse_mode="dense", delta_form=True),       # delta
])
def test_checkpointed_run_matches_straight_run(tmp_path, kw):
    model = AdvectionDiffusion(ProblemConfig(n=N, num_steps=STEPS),
                               SolverConfig(dtype=torch.float64, num_levels=3,
                                            **kw), device="cpu")
    straight, _ = model.run(warn=False)
    mgr = CheckpointManager(tmp_path / "ck", model.problem)
    uT, steps = run_with_checkpoints(model, mgr, every=3)
    assert steps == STEPS and mgr.steps() == [3, 6, 8]
    np.testing.assert_allclose(uT.numpy(), straight.numpy(), atol=1e-14)

    # a run cut after step 5 resumes from its last snapshot
    mgr2 = CheckpointManager(tmp_path / "ck2", model.problem)
    u, _ = model.run_chunk(model.u0, 5)
    mgr2.save(5, model.crop(u))
    uT2, steps = run_with_checkpoints(model, mgr2, every=3)
    assert steps == STEPS
    np.testing.assert_allclose(uT2.numpy(), straight.numpy(), atol=1e-14)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jm, tm = _models()
    jmgr = JCheckpointManager(tmp_path / "ck", jm.problem)
    u, _ = jm.run_chunk(jm.u0, 4)
    jmgr.save(4, jm.crop(u))
    juT, _ = jm.run(warn=False)
    uT, steps = run_with_checkpoints(
        tm, CheckpointManager(tmp_path / "ck", tm.problem), every=3)
    assert steps == STEPS
    np.testing.assert_allclose(uT.numpy(), np.asarray(juT), rtol=0,
                               atol=1e-12)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jm, tm = _models()
    tmgr = CheckpointManager(tmp_path / "ck", tm.problem)
    u, _ = tm.run_chunk(tm.u0, 4)
    tmgr.save(4, tm.crop(u))
    tuT, _ = tm.run(warn=False)
    uT, steps = j_run_with_checkpoints(
        jm, JCheckpointManager(tmp_path / "ck", jm.problem), every=3)
    assert steps == STEPS
    np.testing.assert_allclose(np.asarray(uT), tuT.numpy(), rtol=0,
                               atol=1e-12)


def test_run_chunk_and_pad():
    _, tm = _models()
    u, stats = tm.run_chunk(tm.u0, 2)
    assert u.shape == tm.u0.shape and stats["rel_residual"].shape == (2,)
    assert torch.equal(tm.pad(tm.crop(u)), u)


@pytest.mark.parametrize("kw", [
    dict(cycle_shape=1, cycle_mode="adaptive"),
    dict(cycle_shape=2, cycle_mode="adaptive"),
    dict(cycle_shape=1, cycle_mode="fixed", num_cycles=2),
    dict(cycle_shape=2, cycle_mode="fixed", num_cycles=3),
])
def test_phase_counts_match_jax(kw):
    for levels in (2, 5):
        assert (profiling._phase_counts(SolverConfig(**kw), levels)
                == j_phase_counts(JSolver(**kw), levels))


def test_measure_phases_covers_every_phase():
    _, tm = _models(cycle_mode="fixed", num_cycles=1, coarse_mode="dense")
    records = profiling.measure_phases(tm, reps=1, inner=2)
    assert {r["phase"] for r in records} == PHASES
    assert all(set(r) == RECORD_KEYS for r in records)
    assert all(r["best_ms"] > 0 for r in records)
    smooth = {r["level"] for r in records if r["phase"] == "smooth"}
    assert smooth == {0, 1}


def test_profile_step_and_trace(tmp_path):
    _, tm = _models(steps=2, cycle_mode="fixed", num_cycles=1,
                    coarse_mode="gs")
    prof = profiling.profile_step(tm, reps=1, inner=2)
    assert set(prof) == {"step_ms", "modeled_ms", "fusion_gain_ms",
                         "phase_share", "phase_ms", "phases"}
    assert all(set(r) >= RECORD_KEYS | {"per_step_count", "per_step_ms"}
               for r in prof["phases"])
    assert sum(prof["phase_share"].values()) == pytest.approx(1.0)
    logdir = profiling.trace_step(tm, str(tmp_path / "trace"), nsteps=1)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert logdir == str(tmp_path / "trace")


def test_kernel_byte_model_at_the_main_path():
    """The byte model at n=1024 in float32 (level 0 1032x1152): K1 moves 8
    arrays, K2's pre-smooth 4.5 and post-smooth 7, K8 9.5; bound by
    bytes at 3.35 TB/s."""
    from hpcclassmultigridproject_tpu_torch.mg.levels import Level

    v = torch.zeros((1032, 1152))
    fine = Level(v1=v, v2=v, a_inv=None, n=1024, h=1 / 1024, dt=1e-4,
                 nu=-4e-4, diag_a=1.0, diag_b=1.0)
    array = 1032 * 1152 * 4
    b, f = profiling.open_cost(fine, 4)
    assert b == 8 * array and f > 0
    assert profiling.smooth_cost(fine, 4, 3, read_u=False,
                                 want_residual=True,
                                 res_dec=True)[0] == 4.5 * array
    assert profiling.smooth_cost(fine, 4, 3, corr=True,
                                 want_residual=True)[0] == 7 * array
    b8, f8 = profiling.open_smooth_cost(fine, 4, 3, res_dec=True)
    assert b8 == 9.5 * array
    ms, by = profiling.bound_ms(b8, f8, 4)
    assert by == "bytes" and ms == pytest.approx(9.5 * array / 3.35e9)
    assert profiling.bound_ms(1.0, 1e12, 8)[1] == "operations"
    x = torch.zeros((64, 256))
    assert profiling.io_cost([x], [x[::2]], 7.0) == (3 * 32 * 256 * 4, 7.0)
