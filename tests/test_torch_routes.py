"""PyTorch port: the routes of a solve.

The JAX package's four switches of the main path (`mg/cycle.py`
`_FUSE_CORR`, `_USE_TOWER`, `_RESTRICT_DEC` and `mg/delta.py` `_FUSE_OPEN`),
each turned off, take the unfused form: the port's delta run then equals
its default run to the bit, and the JAX package's run with the same switch
off (backend "pallas", Pallas in interpret mode, so that the switch
applies) at tests/test_torch_delta.py's bounds, atol 1e-8 in float32 and
1e-12 in float64.  `backend="jnp"` runs every kernel wrapper on the plain
route and equals "auto"; a solve leaves the route as it found it, also
when it raises; and each switch is read at each call.

n=64, 3 levels (the tower at level 1), 5 steps, certify_every=2.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.mg.cycle as j_cycle
import hpcclassmultigridproject_tpu.mg.delta as j_delta
import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch import cli
from hpcclassmultigridproject_tpu_torch.mg import cycle as t_cycle
from hpcclassmultigridproject_tpu_torch.mg import delta as t_delta
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion, Poisson
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.parallel import resolve_layout

N, STEPS = 64, 5
_RUN = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
            delta_form=True, num_levels=3, certify_every=2)
_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_ATOL = {jnp.float32: 1e-8, jnp.float64: 1e-12}
# each switch: the module that holds it in the port and in the JAX package
SWITCHES = {"_FUSE_CORR": (t_cycle, j_cycle),
            "_USE_TOWER": (t_cycle, j_cycle),
            "_RESTRICT_DEC": (t_cycle, j_cycle),
            "_FUSE_OPEN": (t_delta, j_delta)}
# the kernel wrappers and transfers of one run, by the form they were
# called in, for 5 steps of one V-cycle over 3 levels
DEFAULT_CALLS = {"K1": STEPS, "tower": STEPS, "K2 zero dec": STEPS,
                 "K2 corr": STEPS, "restrict_inject_rows_decimated": STEPS}
SWITCH_CALLS = {
    "_FUSE_CORR": {"K1": STEPS, "tower": STEPS, "K2 zero dec": STEPS,
                   "K2": STEPS, "restrict_inject_rows_decimated": STEPS},
    # level 1 (n=32) smooths per level, and the dense solve sits below it
    "_USE_TOWER": {"K1": STEPS, "K2 zero dec": 2 * STEPS,
                   "K2 corr": 2 * STEPS,
                   "restrict_inject_rows_decimated": 2 * STEPS},
    "_RESTRICT_DEC": {"K1": STEPS, "tower": STEPS, "K2 zero": STEPS,
                      "K2 corr": STEPS, "restrict_inject": STEPS},
    "_FUSE_OPEN": {"tower": STEPS, "K2 zero dec": STEPS, "K2 corr": STEPS,
                   "restrict_inject_rows_decimated": STEPS},
}


@pytest.fixture(autouse=True)
def _interpret_and_threads():
    old_interpret, old_threads = psm.INTERPRET, torch.get_num_threads()
    psm.INTERPRET = True
    torch.set_num_threads(2)
    yield
    psm.INTERPRET = old_interpret
    torch.set_num_threads(old_threads)


def _port_model(tdtype=torch.float32, backend="auto"):
    return AdvectionDiffusion(
        ProblemConfig(n=N, num_steps=STEPS),
        SolverConfig(dtype=tdtype, refine_dtype=torch.float64,
                     backend=backend, **_RUN), device="cpu")


def _k2_form(args, kwargs):
    return " ".join(["K2"] + [tag for tag, on in (
        ("zero", kwargs.get("zero_init")),
        ("corr", kwargs.get("corr") is not None),
        ("dec", kwargs.get("residual_rows_decimated"))) if on])


def _spy(monkeypatch) -> collections.Counter:
    """Count the calls of the opening, the smoother, the tower and the
    injections that mg/cycle.py and mg/delta.py make, by form."""
    calls = collections.Counter()

    def wrap(module, name, key):
        real = getattr(module, name)

        def spy(*args, **kwargs):
            calls[key(args, kwargs)] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)

    wrap(t_delta, "fused_accumulate_open", lambda a, k: "K1")
    wrap(t_cycle, "tower_vcycle", lambda a, k: "tower")
    wrap(t_cycle, "fused_rb_sweeps", _k2_form)
    for name in ("restrict_inject", "restrict_inject_rows_decimated"):
        wrap(t_cycle, name, lambda a, k, name=name: name)
    return calls


def _route_spy(monkeypatch) -> list:
    """Record, at every kernel wrapper's routing decision, whether the
    plain route was on: a CUDA tensor launches the kernel only where it
    was off."""
    seen, real = [], cuda.use_kernel

    def spy(*tensors):
        seen.append(cuda._plain_on_cuda)
        return real(*tensors)

    monkeypatch.setattr(cuda, "use_kernel", spy)
    return seen


@pytest.fixture(scope="module")
def default_runs():
    return {jd: _port_model(td).run(warn=False) for jd, td in _DTYPES.items()}


def test_default_run_calls_the_fused_forms(monkeypatch):
    calls = _spy(monkeypatch)
    _port_model().run(warn=False)
    assert calls == collections.Counter(DEFAULT_CALLS)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_off_takes_the_unfused_form(monkeypatch, switch):
    monkeypatch.setattr(SWITCHES[switch][0], switch, False)
    calls = _spy(monkeypatch)
    _port_model().run(warn=False)
    assert calls == collections.Counter(SWITCH_CALLS[switch])


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_off_equals_the_default_run(monkeypatch, default_runs,
                                           switch, jdtype):
    monkeypatch.setattr(SWITCHES[switch][0], switch, False)
    uT, stats = _port_model(_DTYPES[jdtype]).run(warn=False)
    want_uT, want_stats = default_runs[jdtype]
    assert torch.equal(uT, want_uT)
    for key in want_stats:
        assert torch.equal(stats[key], want_stats[key]), key


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_off_matches_jax_with_the_switch_off(monkeypatch, switch,
                                                    jdtype):
    t_mod, j_mod = SWITCHES[switch]
    monkeypatch.setattr(t_mod, switch, False)
    monkeypatch.setattr(j_mod, switch, False)
    jm = JModel(JProblem(n=N, num_steps=STEPS),
                JSolver(dtype=jdtype, refine_dtype=jnp.float64,
                        backend="pallas", **_RUN))
    juT, jstats = jm.run(warn=False)
    uT, stats = _port_model(_DTYPES[jdtype]).run(warn=False)
    np.testing.assert_allclose(uT.numpy(), np.asarray(juT), rtol=0,
                               atol=_ATOL[jdtype])
    rel = stats["rel_residual"].numpy()
    hi = stats["rel_residual_hi_steps"].numpy()
    assert (rel <= 1e-6).all() and float(stats["final_rel_residual_hi"]) <= 1e-6
    np.testing.assert_array_equal(hi < 0,
                                  np.asarray(jstats["rel_residual_hi_steps"]) < 0)


def test_open_smooth_residual_follows_restrict_dec(monkeypatch, default_runs):
    """K8's residual is row-decimated as `_RESTRICT_DEC` says, and
    `_FUSE_OPEN` off also turns K8 off, as in the JAX package."""
    monkeypatch.setattr(t_delta, "_FUSE_OPEN_SMOOTH", True)
    forms, real = [], t_delta.fused_open_presmooth

    def spy(*args, **kwargs):
        forms.append(kwargs["residual_rows_decimated"])
        return real(*args, **kwargs)

    monkeypatch.setattr(t_delta, "fused_open_presmooth", spy)
    model = _port_model()
    want = default_runs[jnp.float32][0]
    for dec in (True, False):
        forms.clear()
        monkeypatch.setattr(t_cycle, "_RESTRICT_DEC", dec)
        uT, _ = model.run(warn=False)
        assert forms == [dec] * STEPS
        assert torch.equal(uT, want)
    monkeypatch.setattr(t_delta, "_FUSE_OPEN", False)
    forms.clear()
    assert torch.equal(model.run(warn=False)[0], want)
    assert forms == []


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_each_switch_is_read_at_call_time(monkeypatch, switch):
    model = _port_model()
    calls = _spy(monkeypatch)
    counts = []
    for on in (True, False, True):
        monkeypatch.setattr(SWITCHES[switch][0], switch, on)
        calls.clear()
        model.run(warn=False)
        counts.append(dict(calls))
    assert counts[0] == DEFAULT_CALLS == counts[2]
    assert counts[1] == SWITCH_CALLS[switch]


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32])
def test_jnp_backend_equals_auto(default_runs, jdtype):
    uT, stats = _port_model(_DTYPES[jdtype], backend="jnp").run(warn=False)
    want_uT, want_stats = default_runs[jdtype]
    assert torch.equal(uT, want_uT)
    for key in want_stats:
        assert torch.equal(stats[key], want_stats[key]), key


@pytest.mark.parametrize("backend,plain", [("jnp", True), ("auto", False),
                                           ("pallas", False)])
def test_backend_picks_the_route_of_every_wrapper(monkeypatch, backend,
                                                  plain):
    seen = _route_spy(monkeypatch)
    _port_model(backend=backend).run(warn=False)
    # K1, K2 twice and the tower's two halves a step
    assert len(seen) == 5 * STEPS
    assert set(seen) == {plain}
    assert cuda._plain_on_cuda is False


@pytest.mark.parametrize("method", ["mg", "gs"])
def test_poisson_solves_on_the_route_of_their_backend(monkeypatch, method):
    seen = _route_spy(monkeypatch)
    for backend in ("jnp", "auto"):
        seen.clear()
        model = Poisson(32, solver=SolverConfig(
            restriction="full", coarse_mode="dense", num_levels=2,
            tol=1e-6, backend=backend), device="cpu")
        model.solve(method, max_iters=200, check_every=100)
        assert seen and set(seen) == {backend == "jnp"}


def test_jnp_solve_leaves_the_route_as_found(monkeypatch):
    model = _port_model(backend="jnp")
    model.run(warn=False)
    assert cuda._plain_on_cuda is False
    with cuda.plain_route():
        model.run(warn=False)
        assert cuda._plain_on_cuda is True
        _port_model().run(warn=False)
        assert cuda._plain_on_cuda is True
    assert cuda._plain_on_cuda is False

    def fail(*args, **kwargs):
        assert cuda._plain_on_cuda is True
        raise RuntimeError("inside the solve")

    monkeypatch.setattr(t_cycle, "tower_vcycle", fail)
    with pytest.raises(RuntimeError, match="inside the solve"):
        model.run(warn=False)
    assert cuda._plain_on_cuda is False
    with cuda.plain_route():
        with pytest.raises(RuntimeError, match="inside the solve"):
            model.run(warn=False)
        assert cuda._plain_on_cuda is True
    assert cuda._plain_on_cuda is False


@pytest.mark.parametrize("argv", [
    ["run", "--n", "32", "--steps", "2", "--levels", "3", "--delta",
     "--cycle-mode", "fixed", "--num-cycles", "1", "--coarse", "dense"],
    ["profile", "--n", "32", "--steps", "2", "--levels", "3",
     "--cycle-mode", "fixed", "--num-cycles", "1", "--coarse", "dense",
     "--reps", "1"],
])
def test_cli_backend_reaches_the_solve(monkeypatch, capsys, argv):
    seen = _route_spy(monkeypatch)
    for backend in ("jnp", "auto"):
        seen.clear()
        assert cli.main([*argv, "--backend", backend, "--device", "cpu"]) == 0
        assert seen and set(seen) == {backend == "jnp"}
    capsys.readouterr()


@pytest.mark.parametrize("backend,want", [("auto", "rows"), ("pallas", "rows"),
                                          ("jnp", "2d")])
def test_auto_layout_follows_the_route(backend, want):
    """`layout="auto"` takes rows where K7 smooths (red–black GS on the
    kernel route) and 2-D blocks under backend "jnp", which launches no
    kernel, as the JAX package's rule does for its jnp backend."""
    cfg = SolverConfig(dtype=torch.float64, backend=backend)
    assert resolve_layout("auto", cfg) == want
    assert resolve_layout("rows", cfg) == "rows"
    if backend == "jnp":
        assert not j_cycle._pallas_backend_ok(
            JSolver(dtype=jnp.float64, backend="jnp"), None)
