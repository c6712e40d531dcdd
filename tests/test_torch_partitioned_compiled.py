"""PyTorch port: the partitioned run as one compiled program
(`parallel.distributed_run` and the born-partitioned model's `run`,
`step` and `run_chunk` through utils/graphs.py), on the CPU.

On the card under NCCL, with `parallel.distributed.CAPTURE_NCCL` on (it
is off by default), every rank captures its partitioned call once as a
CUDA graph, halo exchanges and norms included, and replays it.  Here the
ranks are spawned processes over gloo on CPU tensors (not staged through
the host, so capturable), each with one torch thread; in every rank the
stand-in of tests/capture_stand_in.py takes the place of torch's CUDA
graph, and the models read the capture rule as a rank on its card under
NCCL with the switch on reads it (`_as_on_card`).  The stand-in's
capture runs the call once inside `no_host_reads`, its replay runs it
again, collectives and all, so the ranks' replays meet as NCCL's kernels
do on the cards.

Each case (W=2 and W=4, n=32, 3 steps; the configurations are
tests/test_torch_parallel.py's `CONFIGS` "*_32") runs eagerly (the real
`graphs.CAPTURE` on the CPU calls the function directly), then on the
stand-in, and on every rank: the capture reads nothing back to the host;
the replay equals the eager run to the bit (uT and every stats tensor);
the replay's LAUNCHES and COLLECTIVES equal the eager run's (`while_set`
against its host tests); and the WHILE nodes' trips are the same on
every rank.  The adaptive configurations (adaptive_f64_32, and
jacobi_32, whose cycle_mode is the adaptive default) are no capture: the
rule keeps them eager with its reason (the norm's all-gather would sit
in a WHILE body), and the case checks that reason on every rank.  Rank
0's result also meets the JAX package's
`distributed_run` on its CPU mesh (test_torch_parallel.py's `_jax_dist`)
at that file's bars: 1e-12 in float64, 1e-8 for the delta path
(9.313e-9 measured there), with equal cycle counts.

The unit tests: a program's key differs by mesh, layout and min_local;
an exchange left unwaited inside a capture raises, and so does a
host-staged collective; the rules of `capture_reason` /
`eager_reason`; and a replay adds COLLECTIVES as it adds LAUNCHES.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.models import advection_diffusion
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.parallel import (
    Mesh,
    capture_reason,
    distributed,
    distributed_run,
    launch_local,
    make_mesh,
    rows_halo,
)
from hpcclassmultigridproject_tpu_torch.utils import graphs

from capture_stand_in import StandIn, no_host_reads
from test_torch_parallel import CONFIGS, _jax_dist, _solver

CPU_REASON = "the CPU was asked for: the function is called directly"
# (config, layout, build, min_local): min_local as tests/test_torch_parallel
# runs them; build "whole" (distributed_run partitions the model) or "born"
# (AdvectionDiffusion(mesh=...), run as built)
CASES = {
    2: [(name, layout, "whole", 8) for name in ("delta_32",
                                                 "delta_overlap_32")
        for layout in ("rows", "2d")]
       + [("delta_32", layout, "born", 8) for layout in ("rows", "2d")]
       + [("adaptive_f64_32", "rows", "whole", 8)],
    4: [(name, layout, "whole", 8) for name in ("delta_32",
                                                 "delta_overlap_32")
        for layout in ("rows", "2d")]
       + [("delta_32", "2d", "born", 8), ("fmg_32", "2d", "whole", 8),
          ("jacobi_32", "rows", "whole", 8),
          ("adaptive_f64_32", "rows", "whole", 1)],
}
# the bar against the JAX package's distributed_run
BOUNDS = {"delta_32": 1e-8, "delta_overlap_32": 1e-8,
          "adaptive_f64_32": 1e-12, "fmg_32": 1e-12, "jacobi_32": 1e-12}


def _model(name, mesh=None, layout="auto", min_local=64):
    p, s = CONFIGS[name]
    s = SolverConfig(**_solver(s, torch))
    kw = {} if mesh is None else dict(mesh=mesh, layout=layout,
                                      min_local=min_local)
    return AdvectionDiffusion(ProblemConfig(**p), s, device="cpu", **kw)


def _all_ranks(value) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _equal(a, b) -> bool:
    """Two outputs (a tensor, or a (tensor, stats) pair) to the bit."""
    (ua, sa), (ub, sb) = a, b
    return (torch.equal(ua, ub) and set(sa) == set(sb)
            and all(torch.equal(sa[k], sb[k]) for k in sa))


def _eager_counts() -> dict:
    """LAUNCHES and COLLECTIVES of an eager run, its host tests standing
    for the `while_set` launches a replay makes in their place."""
    return dict(graphs.counts(), while_set=cuda.HOST_TESTS["while_set"])


@contextlib.contextmanager
def _as_on_card(stand_in):
    """`graphs.CAPTURE` replaced by `stand_in`, and the models' capture
    rule read as a rank of the same world on its card under NCCL, with
    `CAPTURE_NCCL` on, reads it (CPU tensors under gloo are not staged
    through the host, so the stand-in can capture their collectives)."""
    def rule(mesh, device, solver=None):
        nccl = types.SimpleNamespace(world=mesh.world, backend="nccl")
        return capture_reason(nccl, "cuda", solver)

    real = (graphs.CAPTURE, advection_diffusion.capture_reason,
            distributed.CAPTURE_NCCL)
    graphs.CAPTURE, advection_diffusion.capture_reason = stand_in, rule
    distributed.CAPTURE_NCCL = True
    try:
        yield stand_in
    finally:
        (graphs.CAPTURE, advection_diffusion.capture_reason,
         distributed.CAPTURE_NCCL) = real


def _eager_and_replayed(model, call):
    """`call()` eagerly and then as a rank on its card under NCCL would
    run it (`_as_on_card`, the stand-in's capture inside `no_host_reads`)
    on this rank: (eager out, its counts, the second out, its counts,
    the program, the stand-in)."""
    cuda.reset_launches()
    eager = call()
    assert not model.last_run_compiled
    assert model.last_run_reason == CPU_REASON
    want = _eager_counts()
    with _as_on_card(StandIn(guard=no_host_reads)) as fake:
        cuda.reset_launches()
        got = call()
        counts = (graphs.counts() if model.last_run_compiled
                  else _eager_counts())
    return eager, want, got, counts, model.programs.last, fake


def _case(mesh, name, layout, build, min_local) -> dict:
    """One case on this rank: distributed_run eagerly and replayed; a
    born model's `run` and `step` too."""
    if build == "born":
        model = _model(name, mesh, layout, min_local)
        kw = {}
    else:
        model = _model(name)
        kw = dict(min_local=min_local, layout=layout)
    eager, want, got, counts, program, fake = _eager_and_replayed(
        model, lambda: distributed_run(model, **kw))
    loops = None if program is None else program.loops
    trips = loops.trips[:len(loops)].tolist() if loops else []
    checks = {"bits": _equal(eager, got), "counts": counts == want,
              "captures": fake.captures, "trips": trips,
              "compiled": model.last_run_compiled,
              "reason": model.last_run_reason,
              "collectives": {k: counts[k] for k in cuda.COLLECTIVES}}
    if build == "born":
        run = _eager_and_replayed(model, lambda: model.run(warn=False))
        step = _eager_and_replayed(model, lambda: model.step(model.u0))
        checks["run"] = _equal(run[0], run[2]) and run[1] == run[3]
        checks["run_equals_distributed_run"] = _equal(run[2], got)
        checks["step"] = _equal(step[0], step[2]) and step[1] == step[3]
    uT, stats = got
    return {"checks": _all_ranks(checks), "uT": uT.numpy(),
            "stats": {k: v.numpy() for k, v in stats.items()}}


def _keys(mesh) -> dict:
    """The programs one whole model captures over (mesh, layout,
    min_local) = (world, rows, 8), (world, 2d, 8), (world, rows, 16) and
    (one rank, rows, 8), then (world, rows, 8) again: the count after each
    call, and the partition part of each program's key."""
    model = _model("delta_32")
    sizes = []
    with _as_on_card(StandIn()):
        for m, layout, min_local in ((mesh, "rows", 8), (mesh, "2d", 8),
                                     (mesh, "rows", 16), (Mesh(1), "rows", 8),
                                     (mesh, "rows", 8)):
            distributed_run(model, m, min_local=min_local, layout=layout)
            sizes.append(len(model.programs))
    return {"sizes": sizes,
            "parts": [full[0][3:] for full in model.programs._programs]}


def _unwaited(mesh) -> str:
    """The error of a capture that posts an exchange and never waits on
    it (waited afterwards, so that no receive is left open)."""
    posted = []

    def fn(x):
        posted.append(rows_halo.start_exchange([x], 1, mesh))
        return 2.0 * x

    real, graphs.CAPTURE = graphs.CAPTURE, StandIn()
    try:
        graphs.Programs()("unwaited", fn, (torch.ones(2, 3),),
                          lambda x: posted.append(None) or 2.0 * x)
    except RuntimeError as err:
        return str(err)
    finally:
        graphs.CAPTURE = real
        for ex in posted:
            if ex is not None:
                ex.wait()
    return "no error"


def rank_cases(cases, units: bool) -> dict:
    """One rank: every case, and with `units` the key and unwaited
    checks."""
    torch.set_num_threads(1)
    mesh = make_mesh()
    out = {case: _case(mesh, *case) for case in cases}
    if units:
        out["keys"] = _keys(mesh)
        out["unwaited"] = _unwaited(mesh)
    assert not graphs.POSTED
    return out


@pytest.fixture(scope="module")
def spawned():
    """{world: rank 0's results} from one spawn per world size."""
    return {w: launch_local(rank_cases, w, (cases, w == 2))
            for w, cases in CASES.items()}


_ALL = [(w, case) for w, cases in CASES.items() for case in cases]


@pytest.mark.parametrize("world,case", _ALL,
                         ids=[f"W{w}-{'-'.join(map(str, c))}"
                              for w, c in _ALL])
def test_replay_equals_eager_and_jax(spawned, world, case):
    name, layout, build, min_local = case
    got = spawned[world][case]
    checks = got["checks"]
    assert len(checks) == world
    # an adaptive solve (Jacobi's too): its norm would sit in a WHILE body
    adaptive = _model(name).solver.cycle_mode not in ("fixed", "fmg")
    for rank, c in enumerate(checks):
        assert c["bits"], f"rank {rank}: replay differs from eager"
        assert c["counts"], f"rank {rank}: counts differ from eager"
        assert c["trips"] == checks[0]["trips"], "trips differ by rank"
        assert c["collectives"] == checks[0]["collectives"]
        if adaptive:
            # eager on every rank, decided from the configuration
            assert not c["compiled"] and c["captures"] == 0
            assert "WHILE body" in c["reason"], c["reason"]
        else:
            assert c["compiled"] and c["reason"] is None
            assert c["captures"] == 1, f"rank {rank}: not one capture"
        if build == "born":
            assert c["run"] and c["step"] and c["run_equals_distributed_run"]
    assert checks[0]["collectives"]["batch_isend_irecv"] > 0
    assert checks[0]["collectives"]["all_gather"] > 0
    juT, jstats = _jax_dist(name, world, min_local)
    np.testing.assert_allclose(got["uT"], juT, rtol=0, atol=BOUNDS[name])
    np.testing.assert_array_equal(got["stats"]["cycles"], jstats["cycles"])


def test_key_holds_mesh_layout_and_min_local(spawned):
    keys = spawned[2]["keys"]
    assert keys["sizes"] == [1, 2, 3, 4, 4]
    world = (2, 0, (1, 2), "gloo")
    assert keys["parts"] == [(world, "rows", 8), (world, "2d", 8),
                             (world, "rows", 16),
                             ((1, 0, (1, 1), "gloo"), "rows", 8)]


def test_unwaited_exchange_in_a_capture_raises(spawned):
    assert "never waited on" in spawned[2]["unwaited"]


def test_host_staged_collective_in_a_capture_raises():
    """A CUDA tensor under gloo is staged through the host: outside a
    capture that is allowed, inside one it raises (the rule reads the
    tensor's is_cuda and device, and the mesh's backend)."""
    mesh = types.SimpleNamespace(backend="gloo", rank=0)
    on_card = types.SimpleNamespace(is_cuda=True,
                                    device=torch.device("cuda", 0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CAPTURE", StandIn())
        assert distributed.host_staged(mesh, on_card)

        def fn(x):
            distributed.host_staged(mesh, on_card)
            return x + 1.0

        with pytest.raises(RuntimeError, match="through the host"):
            graphs.Programs()("staged", fn, (torch.ones(2),))


def test_capture_and_eager_reasons():
    """The CPU: the CPU's reason.  On the card: one rank, None; gloo with
    CUDA tensors, the staging reason; NCCL with CAPTURE_NCCL off (the
    default), the switch's reason for every solver; with it on, None for
    fixed-cycle and FMG solves and the WHILE body's reason for an
    adaptive one."""
    parted = _model("delta_32", Mesh(2, 0), "rows", 8)
    adaptive = _model("adaptive_f64_32").solver
    fixed, fmg = parted.solver, _model("fmg_32").solver
    assert not distributed.CAPTURE_NCCL
    assert parted.eager_reason() == CPU_REASON
    assert capture_reason(Mesh(2, 0), "cpu") == CPU_REASON
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CAPTURE", StandIn())
        assert capture_reason(Mesh(1), "cuda", adaptive) is None
        mp.setattr(Mesh, "backend", property(lambda self: "gloo"))
        for solver in (None, fixed, fmg, adaptive):
            assert "under gloo" in capture_reason(Mesh(2, 0), "cuda", solver)
        parted.device = torch.device("cuda")
        assert "stage CUDA tensors through the host" in parted.eager_reason()
        mp.setattr(Mesh, "backend", property(lambda self: "nccl"))
        for solver in (None, fixed, fmg, adaptive):
            reason = capture_reason(Mesh(2, 0), "cuda", solver)
            assert "CAPTURE_NCCL" in reason, reason
        assert "CAPTURE_NCCL" in parted.eager_reason()
        mp.setattr(distributed, "CAPTURE_NCCL", True)
        for solver in (None, fixed, fmg):
            assert capture_reason(Mesh(2, 0), "cuda", solver) is None
        assert parted.eager_reason() is None
        assert "WHILE body" in capture_reason(Mesh(2, 0), "cuda", adaptive)
        assert capture_reason(Mesh(1), "cuda", adaptive) is None


def test_replays_add_collectives_and_the_reset_clears_them():
    """A replay adds the collectives its capture counted, as it adds
    launches; the warm-up and the capture leave the counts as they were;
    `reset_launches` zeroes COLLECTIVES with LAUNCHES."""
    def fn(x):
        cuda.COLLECTIVES["all_gather"] += 2
        cuda.COLLECTIVES["batch_isend_irecv"] += 1
        cuda.LAUNCHES["smooth_rows"] += 3
        return 2.0 * x

    cuda.reset_launches()
    programs = graphs.Programs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CAPTURE", StandIn())
        for k in range(1, 4):
            programs("f", fn, (torch.ones(2),))
            assert cuda.COLLECTIVES == {"batch_isend_irecv": k,
                                        "all_gather": 2 * k}
            assert cuda.LAUNCHES["smooth_rows"] == 3 * k
    assert programs.last.launches == {"smooth_rows": 3, "all_gather": 2,
                                      "batch_isend_irecv": 1}
    cuda.reset_launches()
    assert not any(cuda.COLLECTIVES.values())
    assert not any(cuda.LAUNCHES.values())
