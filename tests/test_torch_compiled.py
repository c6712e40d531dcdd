"""PyTorch port: the compiled run (utils/graphs.py), on the CPU.

On the card each model entry point (`AdvectionDiffusion.run`, `step`,
`run_chunk`, `Poisson.solve("mg")` in fixed and fmg mode) replays a CUDA
graph captured once per key, the counterpart of the JAX model's `jax.jit`
programs.  Here:

(i) a strict host-read guard (`Tensor.__bool__`, `__float__`, `__int__`,
    `item`, `tolist`, `cpu`, `numpy`, `torch.tensor` and `torch.as_tensor`
    raise) over every configuration the models capture: each runs to its
    end and is compiled on the stand-in below; each adaptive solve, the GS
    coarse solve and Poisson's "gs" trip the guard eagerly (their host
    loops) and are compiled, their capture reading nothing, on the
    stand-in (their `while_loop`s as its conditional nodes);
(ii) the bookkeeping of `graphs.Programs` with a stand-in for torch's CUDA
    graph, which replays by running the captured function again on the
    static inputs and writing the static outputs in place: the key, fresh
    outputs, inputs copied in, launch counts added on every replay, one
    warm-up and capture per key, a failed capture raised;
(iii) the slice against the JAX package through the same entry points,
    called directly and through the stand-in's capture: the delta main
    configuration at n=64, 5 steps (atol 1e-8, the f32 FMA note of ROADMAP
    queue 3), a fixed float64 run (1e-12), `step` and `run_chunk` against
    `_jit_step` and `_jit_run_chunk`, Poisson fixed and fmg against
    `_jit_mg`;
and the capture repairs, each bit for bit against the form it replaced.
"""

import contextlib
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu.models import Poisson as JPoisson
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.mg import cycle as t_cycle
from hpcclassmultigridproject_tpu_torch.mg import delta as t_delta
from hpcclassmultigridproject_tpu_torch.mg import refine as t_refine
from hpcclassmultigridproject_tpu_torch.mg.timestepper import (
    timestep,
    timestepper,
)
from hpcclassmultigridproject_tpu_torch.models import (
    AdvectionDiffusion,
    Poisson,
)
from hpcclassmultigridproject_tpu_torch.ops import cuda, padded
from hpcclassmultigridproject_tpu_torch.utils import graphs

from capture_stand_in import HostRead, StandIn, no_host_reads

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
N, STEPS = 32, 3


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_guard_bites():
    x = torch.ones(3)
    with no_host_reads():
        for read in (lambda: bool(x[0]), lambda: float(x[0]),
                     lambda: int(x[0]), lambda: x[0].item(), x.tolist,
                     x.cpu, x.numpy, lambda: torch.tensor(1.0),
                     lambda: torch.as_tensor([1.0])):
            with pytest.raises(HostRead):
                read()
    assert bool(x[0])  # restored


# (i) every captured configuration of the models, and the eager ones

_DELTA = dict(dtype=torch.float32, refine_dtype=torch.float64, tol=1e-6,
              cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
              delta_form=True, certify_every=2, num_levels=3)
_FIXED = dict(tol=1e-6, cycle_mode="fixed", num_cycles=2,
              coarse_mode="dense", num_levels=3)
_REFINED = dict(dtype=torch.float32, refine_dtype=torch.float64, tol=1e-6,
                cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
                num_levels=3)
SWITCHES = (("cycle", "_FUSE_CORR"), ("cycle", "_USE_TOWER"),
            ("cycle", "_RESTRICT_DEC"), ("delta", "_FUSE_OPEN"))
_MODULES = {"cycle": t_cycle, "delta": t_delta}

# (name, solver fields, module switches set for the run)
CAPTURED = [
    ("delta main", _DELTA, {}),
    ("delta f64", dict(_DELTA, dtype=torch.float64), {}),
    ("open-smooth", _DELTA, {("delta", "_FUSE_OPEN_SMOOTH"): True}),
    ("mg_solve_fixed", _FIXED, {}),
    ("mg_solve_fixed galerkin", dict(_FIXED, coarse_operator="galerkin",
                                     restriction="full"), {}),
    ("refined fused", _REFINED, {}),
    ("refined fmg", dict(_REFINED, cycle_mode="fmg"), {}),
    ("fmg_solve dense", dict(_FIXED, cycle_mode="fmg", num_cycles=1), {}),
    ("backend jnp", dict(_DELTA, backend="jnp"), {}),
    ("jacobi fixed", dict(_FIXED, smoother="jacobi", jacobi_omega=0.8), {}),
    ("chebyshev fixed", dict(_FIXED, smoother="chebyshev"), {}),
    ("w-cycle fixed", dict(_FIXED, cycle_shape=2), {}),
] + [(f"{switch} off", _DELTA, {(mod, switch): False})
     for mod, switch in SWITCHES]

# configurations whose solves loop on a device predicate
HOST_LOOPS = [
    ("mg_solve adaptive", dict(tol=1e-6, coarse_mode="dense",
                               num_levels=3)),
    ("coarse GS", dict(_FIXED, coarse_mode="gs")),
    ("refined adaptive", dict(_REFINED, cycle_mode="adaptive")),
    ("delta GS coarse", dict(_DELTA, coarse_mode="gs")),
]


def _model(fields, n=N, steps=STEPS):
    return AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                              SolverConfig(**fields), device="cpu")


@contextlib.contextmanager
def _switched(settings):
    with pytest.MonkeyPatch.context() as mp:
        for (mod, switch), value in settings.items():
            mp.setattr(_MODULES[mod], switch, value)
        yield


@pytest.mark.parametrize("name,fields,settings", CAPTURED,
                         ids=[c[0] for c in CAPTURED])
def test_captured_configuration_reads_nothing_back(name, fields, settings):
    model = _model(fields)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CAPTURE", StandIn())
        assert model.eager_reason() is None
    with _switched(settings), no_host_reads():
        uT, stats = model.run(warn=False)
        u1, _ = model.step(model.u0)
        u2, _ = model.run_chunk(model.u0, 2)
    assert uT.shape == (N + 1, N + 1) and torch.isfinite(uT).all()
    assert stats["rel_residual"].shape == (STEPS,)
    assert torch.isfinite(u1).all() and torch.isfinite(u2).all()


@pytest.mark.parametrize("name,fields", HOST_LOOPS,
                         ids=[c[0] for c in HOST_LOOPS])
def test_host_loop_trips_the_guard(name, fields):
    """Eagerly the loop reads its predicate on the host; captured (the
    stand-in, its capture inside the guard) it reads nothing."""
    model = _model(fields)
    with no_host_reads(), pytest.raises(HostRead):
        model.run(warn=False)
    with pytest.MonkeyPatch.context() as mp:
        fake = StandIn(guard=no_host_reads)
        mp.setattr(graphs, "CAPTURE", fake)
        assert model.eager_reason() is None
        model.run(warn=False)
    assert model.last_run_compiled and fake.captures == 1
    assert len(model.programs.last.loops) > 0


_POISSON = dict(dtype=torch.float64, tol=1e-10, restriction="full",
                coarse_mode="dense", num_levels=3)


@pytest.mark.parametrize("mode", ["fixed", "fmg"])
def test_poisson_captured_solve_reads_nothing_back(mode):
    model = Poisson(n=N, solver=SolverConfig(cycle_mode=mode, num_cycles=3,
                                             **_POISSON), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CAPTURE", StandIn())
        assert model.eager_reason() is None
    with no_host_reads():
        u, stats = model.solve()
    assert u.shape == (N + 1, N + 1) and int(stats["cycles"]) > 0


@pytest.mark.parametrize("method,fields", [
    ("mg", dict(_POISSON)),
    ("mg", dict(_POISSON, cycle_mode="fixed", coarse_mode="gs")),
    ("gs", dict(_POISSON, cycle_mode="fixed")),
], ids=["adaptive", "gs coarse", "gs method"])
def test_poisson_host_loop_trips_the_guard(method, fields):
    """Eagerly the loop reads its predicate on the host; captured (the
    stand-in, its capture inside the guard) it reads nothing."""
    model = Poisson(n=N, solver=SolverConfig(**fields), device="cpu")
    with no_host_reads(), pytest.raises(HostRead):
        model.solve(method, max_iters=200, check_every=100)
    with pytest.MonkeyPatch.context() as mp:
        fake = StandIn(guard=no_host_reads)
        mp.setattr(graphs, "CAPTURE", fake)
        assert model.eager_reason(method) is None
        model.solve(method, max_iters=200, check_every=100)
    assert model.last_run_compiled and fake.captures == 1
    assert len(model.programs.last.loops) > 0


# (ii) the bookkeeping, with a stand-in for torch's CUDA graph

@pytest.fixture
def stand_in(monkeypatch):
    fake = StandIn()
    monkeypatch.setattr(graphs, "CAPTURE", fake)
    return fake


def _counting(counts):
    """A function that adds `counts` to LAUNCHES, as kernel wrappers do,
    and returns its input doubled with stats."""
    def fn(x):
        for k, v in counts.items():
            cuda.LAUNCHES[k] += v
        return 2.0 * x, {"sum": x.sum(), "key": graphs.route_key()[0]}
    return fn


def test_launches_grow_by_the_captured_counts_on_every_replay(stand_in):
    programs = graphs.Programs()
    cuda.reset_launches()
    fn = _counting({"smooth": 3, "tower_descent": 1})
    warm = _counting({"smooth": 100, "delta_open": 5})
    x = torch.arange(4.0)
    for k in range(1, 4):
        out, _ = programs("f", fn, (x,), warm)
        assert torch.equal(out, 2.0 * x)
        assert cuda.LAUNCHES["smooth"] == 3 * k
        assert cuda.LAUNCHES["tower_descent"] == k
        assert cuda.LAUNCHES["delta_open"] == 0
    assert (stand_in.warmups, stand_in.captures) == (1, 1)
    assert programs.last.launches == {"smooth": 3, "tower_descent": 1}
    assert programs.last.nodes == 7 and programs.last.seconds >= 0
    cuda.reset_launches()


def test_outputs_are_fresh_and_inputs_copied_in(stand_in):
    programs = graphs.Programs()
    fn = _counting({})
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    out_a, stats_a = programs("f", fn, (a,))
    kept = out_a.clone()
    out_b, stats_b = programs("f", fn, (b,))
    assert stand_in.captures == 1
    assert torch.equal(out_b, 2.0 * b) and float(stats_b["sum"]) == 46.0
    assert torch.equal(out_a, kept) and float(stats_a["sum"]) == 6.0
    assert out_a.data_ptr() != out_b.data_ptr()
    program = programs.last
    assert all(t.data_ptr() != out_b.data_ptr() for t in program.outputs
               if isinstance(t, torch.Tensor))
    assert program.inputs[0].data_ptr() != b.data_ptr()


def test_key_holds_shape_dtype_route_and_static_part(stand_in):
    programs = graphs.Programs()
    fn = _counting({})
    x = torch.arange(4.0)
    programs("f", fn, (x,))
    programs("f", fn, (x.to(torch.float64),))
    programs("f", fn, (torch.arange(6.0),))
    programs("g", fn, (x,))
    with cuda.plain_route():
        _, stats = programs("f", fn, (x,))
    assert stats["key"] is True
    assert stand_in.captures == len(programs) == 5
    programs("f", fn, (x,))
    assert stand_in.captures == 5


@pytest.mark.parametrize("mod,switch", SWITCHES + (("delta",
                                                    "_FUSE_OPEN_SMOOTH"),))
def test_key_changes_with_each_switch(stand_in, mod, switch):
    programs = graphs.Programs()
    fn = _counting({})
    x = torch.arange(4.0)
    module = _MODULES[mod]
    before = graphs.route_key()
    programs("f", fn, (x,))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, switch, not getattr(module, switch))
        assert graphs.route_key() != before
        programs("f", fn, (x,))
        assert stand_in.captures == 2
    programs("f", fn, (x,))
    assert stand_in.captures == 2


def test_failed_capture_raises_and_runs_nothing_eagerly(monkeypatch):
    monkeypatch.setattr(graphs, "CAPTURE", StandIn(fail=True))
    programs = graphs.Programs()
    cuda.reset_launches()
    calls = []

    def fn(x):
        calls.append(1)
        cuda.LAUNCHES["smooth"] += 1
        return x + 1

    with pytest.raises(RuntimeError, match="capturing"):
        programs("f", fn, (torch.ones(2),))
    assert len(programs) == 0 and programs.last is None
    assert calls == [1]  # the warm-up's, and no eager retry
    assert cuda.LAUNCHES["smooth"] == 0


def test_cpu_calls_directly():
    programs = graphs.Programs()
    out, _ = programs("f", _counting({}), (torch.ones(2),))
    assert torch.equal(out, torch.full((2,), 2.0))
    assert programs.last is None and len(programs) == 0
    model = _model(_DELTA)
    model.run(warn=False)
    assert model.last_run_compiled is False
    assert "CPU" in model.last_run_reason


def test_model_run_step_chunk_through_the_stand_in(stand_in):
    model = _model(_DELTA)
    lv, cfg, hi = model.levels, model.solver, model.fine_hi
    uT, stats = model.run(warn=False)
    assert model.last_run_compiled and model.last_run_reason is None
    want_u, want_s = timestepper(lv, model.u0, STEPS, cfg, hi)
    assert torch.equal(uT, model.crop(want_u))
    assert all(torch.equal(stats[k], want_s[k]) for k in want_s)
    # a second run from another u0: independent tensors, each its own
    other = model.u0 * 0.5
    uT2, _ = model.run(other, warn=False)
    assert torch.equal(uT2, model.crop(timestepper(lv, other, STEPS, cfg,
                                                   hi)[0]))
    assert torch.equal(uT, model.crop(want_u))
    # run_chunk of the run's step count replays the run's program
    u_chunk, _ = model.run_chunk(model.u0, STEPS)
    assert torch.equal(model.crop(u_chunk), uT)
    assert stand_in.captures == 1 and stand_in.warmups == 1
    u1, s1 = model.step(model.u0)
    w1, ws1 = timestep(lv, model.u0, cfg, hi)
    assert torch.equal(u1, w1)
    assert all(torch.equal(s1[k], ws1[k]) for k in ws1)
    u2, _ = model.run_chunk(model.u0, 2)
    assert torch.equal(u2, timestepper(lv, model.u0, 2, cfg, hi)[0])
    assert stand_in.captures == 3
    assert model.programs.last.keep == (model.levels, model.fine_hi)


@pytest.mark.parametrize("mod,switch", SWITCHES + (("delta",
                                                    "_FUSE_OPEN_SMOOTH"),))
def test_flipped_switch_replays_the_flipped_route(stand_in, monkeypatch,
                                                  mod, switch):
    """A switch flipped between calls gives the flipped route's eager uT
    (a stand-in replay reruns the captured function: a stale program would
    run the old route)."""
    model = _model(_DELTA)
    module = _MODULES[mod]
    model.run(warn=False)
    counts = []
    for value in (not getattr(module, switch), getattr(module, switch)):
        monkeypatch.setattr(module, switch, value)
        cuda.reset_launches()
        uT, _ = model.run(warn=False)
        counts.append(stand_in.captures)
        want, _ = timestepper(model.levels, model.u0, STEPS, model.solver,
                              model.fine_hi)
        assert torch.equal(uT, model.crop(want))
    assert counts == [2, 2]


def test_backend_between_calls_is_its_own_program(stand_in):
    model = _model(_DELTA)
    model.run(warn=False)
    model.solver = dataclasses.replace(model.solver, backend="jnp")
    model.run(warn=False)
    assert stand_in.captures == 2


def test_static_outputs_only_when_asked(stand_in):
    """A replay returns clones of the graph's static outputs, which a
    later replay leaves alone; with `fresh=False` the static outputs
    themselves, which the next replay overwrites (a partitioned run's
    gather copies uT straight out of them)."""
    programs = graphs.Programs()

    def fn(x):
        return 2.0 * x, {"sum": x.sum()}

    def call(value, **kw):
        return programs("static", fn, (torch.full((3,), value),), **kw)

    first = call(1.0)
    static = call(2.0, fresh=False)
    assert stand_in.captures == 1
    assert static[0] is programs.last.outputs[0]
    assert static[1]["sum"] is programs.last.outputs[1]
    assert torch.equal(static[0], torch.full((3,), 4.0))
    again = call(3.0, fresh=False)
    assert again[0] is static[0]
    assert torch.equal(static[0], torch.full((3,), 6.0))
    assert float(static[1]["sum"]) == 9.0
    assert torch.equal(first[0], torch.full((3,), 2.0))
    assert float(first[1]["sum"]) == 3.0
    fresh = call(4.0)
    assert fresh[0] is not programs.last.outputs[0]


def test_eager_reasons_on_the_card(stand_in):
    """On the card only a partitioned model runs eagerly: under gloo its
    collectives stage through the host, and under NCCL only with
    `CAPTURE_NCCL` set off; the adaptive solves, the GS coarse solve,
    Poisson's "gs", and a model partitioned under NCCL at the switch's
    default (on) are compiled."""
    from hpcclassmultigridproject_tpu_torch.parallel import Mesh, distributed

    assert _model(_DELTA).eager_reason() is None
    assert _model(HOST_LOOPS[0][1]).eager_reason() is None
    assert _model(HOST_LOOPS[1][1]).eager_reason() is None
    model = _model(HOST_LOOPS[0][1])
    uT, _ = model.run(warn=False)
    assert model.last_run_compiled and model.last_run_reason is None
    assert stand_in.captures == 1
    poisson = Poisson(n=N, solver=SolverConfig(**_POISSON), device="cpu")
    poisson.solve()
    assert poisson.last_run_compiled and poisson.last_run_reason is None
    poisson.solve("gs", max_iters=100, check_every=100)
    assert poisson.last_run_compiled and poisson.last_run_reason is None
    assert stand_in.captures == 3
    parted = AdvectionDiffusion(
        ProblemConfig(n=N, num_steps=STEPS), SolverConfig(**_FIXED),
        device="cpu", mesh=Mesh(2, 0), min_local=8)
    parted.device = torch.device("cuda")  # the rule reads the device type
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Mesh, "backend", property(lambda self: "gloo"))
        assert "partitioned over 2 ranks under gloo" in parted.eager_reason()
        mp.setattr(Mesh, "backend", property(lambda self: "nccl"))
        assert distributed.CAPTURE_NCCL
        assert parted.eager_reason() is None
        mp.setattr(distributed, "CAPTURE_NCCL", False)
        assert "partitioned over 2 ranks" in parted.eager_reason()


def test_checkpointed_run_replays_the_chunk_program(stand_in, tmp_path):
    from hpcclassmultigridproject_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        run_with_checkpoints,
    )

    model = _model(_DELTA, steps=4)
    model.run(warn=False)
    mgr = CheckpointManager(str(tmp_path), model.problem)
    uc, step = run_with_checkpoints(model, mgr, every=2)
    # the delta form restarts its (hi, lo) split at each chunk, eagerly too
    u = model.u0
    for _ in range(2):
        u, _ = timestepper(model.levels, u, 2, model.solver, model.fine_hi)
    assert step == 4 and torch.equal(uc, model.crop(u))
    assert stand_in.captures == 2  # the run's and the 2-step chunk's


# (iii) the slice against the JAX package through the entry points

_JAX_DELTA = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1,
                  coarse_mode="dense", delta_form=True, num_levels=3,
                  certify_every=2)
_JAX_FIXED = dict(dtype=jnp.float64, tol=1e-6, cycle_mode="fixed",
                  num_cycles=2, coarse_mode="dense", num_levels=3)


@functools.cache
def _jax_model(case):
    n, steps = 64, 5
    if case == "delta":
        solver = JSolver(dtype=jnp.float32, refine_dtype=jnp.float64,
                         backend="jnp", **_JAX_DELTA)
    else:
        solver = JSolver(backend="jnp", **_JAX_FIXED)
    return JModel(JProblem(n=n, num_steps=steps), solver)


def _port_model(case):
    n, steps = 64, 5
    if case == "delta":
        fields = dict(_JAX_DELTA, dtype=torch.float32,
                      refine_dtype=torch.float64)
    else:
        fields = dict(_JAX_FIXED, dtype=torch.float64)
    return AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                              SolverConfig(**fields), device="cpu")


@functools.cache
def _jax_run(case):
    uT, stats = _jax_model(case).run(warn=False)
    return np.asarray(uT), {k: np.asarray(v) for k, v in stats.items()}


_ATOL = {"delta": 1e-8, "fixed": 1e-12}


@pytest.fixture(params=["direct", "captured"])
def entry(request, monkeypatch):
    """The models' entry points called directly (the CPU) or through the
    stand-in's capture and replay."""
    if request.param == "captured":
        monkeypatch.setattr(graphs, "CAPTURE", StandIn())
    return request.param


@pytest.mark.parametrize("case", ["delta", "fixed"])
def test_run_matches_jax(entry, case):
    model = _port_model(case)
    juT, jst = _jax_run(case)
    for _ in range(2):  # the capture's call, then a replay
        tuT, tst = model.run(warn=False)
        assert model.last_run_compiled == (entry == "captured")
        np.testing.assert_allclose(tuT.numpy(), juT, rtol=0,
                                   atol=_ATOL[case])
        assert set(tst) == set(jst)
        np.testing.assert_array_equal(tst["cycles"].numpy(), jst["cycles"])
        assert (tst["rel_residual"].numpy() <= 1e-6).all()


@pytest.mark.parametrize("case", ["delta", "fixed"])
def test_step_and_chunk_match_jax(entry, case):
    jm, tm = _jax_model(case), _port_model(case)
    u0 = tm.u0.numpy()
    ju, _ = jm.step(jnp.asarray(u0))
    tu, tst = tm.step(tm.u0)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=_ATOL[case])
    assert tst["rel_residual"].ndim == 0
    jc, jst = jm.run_chunk(jnp.asarray(u0), 3)
    tc, tcs = tm.run_chunk(tm.u0, 3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=_ATOL[case])
    np.testing.assert_array_equal(tcs["cycles"].numpy(),
                                  np.asarray(jst["cycles"]))


def _poisson_fields(mode):
    return dict(tol=1e-10, restriction="full", coarse_mode="dense",
                num_levels=3, cycle_mode=mode, num_cycles=3)


@functools.cache
def _jax_poisson(mode):
    jm = JPoisson(n=64, solver=JSolver(dtype=jnp.float64,
                                       **_poisson_fields(mode)))
    u, stats = jm.solve()
    return np.asarray(u), {k: np.asarray(v) for k, v in stats.items()}


@pytest.mark.parametrize("mode", ["fixed", "fmg"])
def test_poisson_matches_jit_mg(entry, mode):
    tm = Poisson(n=64, solver=SolverConfig(dtype=torch.float64,
                                           **_poisson_fields(mode)),
                 device="cpu")
    ju, jst = _jax_poisson(mode)
    tu, tst = tm.solve()
    assert tm.last_run_compiled == (entry == "captured")
    np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=1e-12)
    assert int(tst["cycles"]) == int(jst["cycles"])
    assert bool(tst["converged"]) == bool(jst["converged"])


# the capture repairs, bit for bit against the forms they replaced

_EDGES = [0.0, -0.0, 1.0, 1.0 / 3.0, 0.1, -4e-4, 1e-310, 5e-324, 1e308,
          3.4028235677973366e38, 3.4028235e38, 1.0000000596046448,
          1.0000001192092896, 65504.0, 65520.0, 6.1e-5, 2.0 ** -24 * 1.5]


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64])
def test_as_dtype_rounds_as_torch_did(dtype):
    rng = np.random.default_rng(15)
    values = _EDGES + list(rng.standard_normal(200) * 10.0 ** rng.integers(
        -40, 40, 200)) + list(rng.uniform(-1, 1, 100))
    for x in values:
        got = padded.as_dtype(float(x), dtype)
        want = torch.tensor(float(x), dtype=dtype).item()
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), x


def test_stats_cycles_equal_the_tensor_they_replaced():
    rel = torch.tensor(3e-7, dtype=torch.float64)
    cfg = SolverConfig(tol=1e-6)
    for cycles in (0, 1, 7, 50):
        got = t_cycle._stats(cycles, rel, cfg)["cycles"]
        want = torch.tensor(cycles, dtype=torch.int32)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["fixed", "fmg", "adaptive"])
def test_refined_cycles_equal_the_tensor_they_replaced(mode):
    model = _model(dict(_REFINED, cycle_mode=mode))
    rhs = padded.compute_rhs(model.fine_hi, model.u0)
    _, stats = t_refine.refined_solve(model.levels, model.fine_hi, model.u0,
                                      rhs, model.solver)
    got = stats["cycles"]
    want = torch.tensor(int(got), dtype=torch.int32)
    assert got.dtype == torch.int32 and got.shape == () and torch.equal(
        got, want)
    if mode != "adaptive":
        assert int(got) == model.solver.num_cycles


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chebyshev_equals_its_tensor_inv_diag_form(dtype):
    """`chebyshev_smooth`'s 1/diag_a, now `torch.full`, holds the bits of
    the `torch.tensor` it replaced, and the smoother's result is equal to
    the bit to the recurrence run on that tensor."""
    model = _model(dict(_FIXED, dtype=dtype))
    rng = np.random.default_rng(3)
    for level in model.levels:
        c = padded.coefs(level)
        full = torch.full((), 1.0 / c.diag_a, dtype=dtype)
        old = torch.tensor(1.0 / c.diag_a, dtype=dtype)
        assert full.dtype == old.dtype and torch.equal(full, old)
        rhs = torch.from_numpy(rng.standard_normal(level.padded)).to(dtype)
        rhs = rhs * padded.interior_mask(level.n, level.padded,
                                         dtype=dtype, device="cpu")
        u = padded.chebyshev_smooth(level, torch.zeros_like(rhs), rhs)
        lam = padded.gershgorin_bound(level, c).to(dtype)
        want = padded.chebyshev_steps(
            torch.zeros_like(rhs),
            lambda v: padded.residual(level, v, rhs, c), lam, old, 3,
            1.0 / 30.0, 1.1)
        assert torch.equal(u, want)


@pytest.mark.parametrize("solve", ["mg_solve_fixed", "fmg_solve",
                                   "chebyshev"])
def test_guard_passes_over_the_repaired_solvers(solve):
    fields = dict(_FIXED, smoother="chebyshev") if solve == "chebyshev" \
        else dict(_FIXED)
    model = _model(fields)
    fn = t_cycle.fmg_solve if solve == "fmg_solve" else t_cycle.mg_solve_fixed
    rhs = padded.compute_rhs(model.levels[0], model.u0)
    with no_host_reads():
        u, stats = fn(model.levels, model.u0, rhs, model.solver)
    assert torch.isfinite(u).all() and stats["cycles"].dtype == torch.int32
