"""PyTorch port: the partitioned run as one compiled program
(`parallel.distributed_run` and the born-partitioned model's `run`,
`step` and `run_chunk` through utils/graphs.py), on the CPU.

On the card under NCCL, with `parallel.distributed.CAPTURE_NCCL` on (the
default), every rank captures its partitioned call once as a CUDA graph,
halo exchanges and norms included, and replays it.  Here the
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
jacobi_32, whose cycle_mode is the adaptive default) are captured too:
every collective of their WHILE bodies takes the peer transport (the
plain version over mailbox files every rank maps, parallel/
distributed.py), every other collective gloo, which each rank's count of
its collectives by transport shows.  Rank 0's result also meets the JAX
package's
`distributed_run` on its CPU mesh (test_torch_parallel.py's `_jax_dist`)
at that file's bars: 1e-12 in float64, 1e-8 for the delta path
(9.313e-9 measured there), with equal cycle counts.

Each entry point (a whole model's `distributed_run`, a born model's
`run`, `step` and `run_chunk`) is captured once at the module's default
(on, as every spawned rank finds it), and its replay equals its eager
run to the bit with equal LAUNCHES and COLLECTIVES on every rank, an
adaptive solve's too; with the switch set off each of them is eager
with the switch's reason.

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
from hpcclassmultigridproject_tpu_torch.ops.cuda import peer
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
def _as_on_card(stand_in, switch: bool | None = True):
    """`graphs.CAPTURE` replaced by `stand_in`, and the models' capture
    rule read as a rank of the same world on its card under NCCL, with
    `CAPTURE_NCCL` set to `switch` (None: as the module has it), reads it
    (CPU tensors under gloo are not staged through the host, so the
    stand-in can capture their collectives)."""
    def rule(mesh, device):
        nccl = types.SimpleNamespace(world=mesh.world, backend="nccl")
        return capture_reason(nccl, "cuda")

    real = (graphs.CAPTURE, advection_diffusion.capture_reason,
            distributed.CAPTURE_NCCL)
    graphs.CAPTURE, advection_diffusion.capture_reason = stand_in, rule
    if switch is not None:
        distributed.CAPTURE_NCCL = switch
    try:
        yield stand_in
    finally:
        (graphs.CAPTURE, advection_diffusion.capture_reason,
         distributed.CAPTURE_NCCL) = real


def _eager_and_replayed(model, call, switch: bool | None = True):
    """`call()` eagerly and then as a rank on its card under NCCL would
    run it (`_as_on_card`, the stand-in's capture inside `no_host_reads`,
    `CAPTURE_NCCL` set to `switch`) on this rank: (eager out, its counts,
    the second out, its counts, the program, the stand-in)."""
    cuda.reset_launches()
    eager = call()
    assert not model.last_run_compiled
    assert model.last_run_reason == CPU_REASON
    want = _eager_counts()
    with _as_on_card(StandIn(guard=no_host_reads), switch) as fake:
        cuda.reset_launches()
        got = call()
        counts = (graphs.counts() if model.last_run_compiled
                  else _eager_counts())
    return eager, want, got, counts, model.programs.last, fake


# this rank's collectives by transport (`_log_transports`)
TRANSPORTS = {"peer": 0, "peer_outside_body": 0, "group_in_body": 0}


def _log_transports() -> None:
    """Count, in TRANSPORTS, the collectives that take the peer transport
    (`peer.exchange`, `peer.gather`), those of them made outside a loop
    body or a compiled program, and the process group's collectives made
    inside a loop body of a program being compiled."""
    def counted(fn, peer_call):
        def call(*args, **kwargs):
            inside = graphs.in_body() and graphs.compiling() is not None
            if peer_call:
                TRANSPORTS["peer"] += 1
                TRANSPORTS["peer_outside_body"] += not inside
            elif inside:
                TRANSPORTS["group_in_body"] += 1
            return fn(*args, **kwargs)
        return call

    peer.exchange = counted(peer.exchange, True)
    peer.gather = counted(peer.gather, True)
    dist.all_gather = counted(dist.all_gather, False)
    dist.batch_isend_irecv = counted(dist.batch_isend_irecv, False)


def _case(mesh, name, layout, build, min_local) -> dict:
    """One case on this rank: distributed_run eagerly and replayed; a
    born model's `run` and `step` too."""
    before = dict(TRANSPORTS)
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
              "collectives": {k: counts[k] for k in cuda.COLLECTIVES},
              "body_collectives": sum(
                  made.get(k, 0) for made in (loops.counts if loops else [])
                  for k in cuda.COLLECTIVES),
              "transports": {k: TRANSPORTS[k] - before[k]
                             for k in TRANSPORTS}}
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


def _gathers_from_static(mesh) -> dict:
    """As a rank on its card under NCCL runs them (`_as_on_card`): a born
    model's `run` from its u0 and then from 2·u0, and a whole model's
    `distributed_run`.  Whether each gather received the program's own
    static output (no clone of the block, `fresh=False`); whether the
    first run's results outlived the second replay (the gather and the
    stats' clones are tensors of their own); the second run against the
    same call made eagerly, to the bit; rank 0's distributed_run uT for
    the JAX package's."""
    from hpcclassmultigridproject_tpu_torch import parallel

    received = []

    def spy(real):
        def call(uT, stats, part):
            received.append(uT)
            return real(uT, stats, part)
        return call

    born = _model("delta_32", mesh, "rows", 8)
    whole = _model("delta_32")
    u_b = 2.0 * born.u0
    eager_b = born.run(u_b, warn=False)
    with pytest.MonkeyPatch.context() as mp, _as_on_card(StandIn()):
        mp.setattr(parallel, "fetch_outputs", spy(parallel.fetch_outputs))
        mp.setattr(advection_diffusion, "fetch_outputs",
                   spy(advection_diffusion.fetch_outputs))
        first = born.run(warn=False)
        kept = (first[0].clone(), {k: v.clone() for k, v in
                                   first[1].items()})
        static = born.programs.last.outputs
        second = born.run(u_b, warn=False)
        dist_out = distributed_run(whole, min_local=8, layout="rows")
        whole_static = whole.programs.last.outputs
    return {"received_static": [received[0] is static[0],
                                received[1] is static[0],
                                received[2] is whole_static[0]],
            "compiled": born.last_run_compiled and whole.last_run_compiled,
            "first_kept": _equal(first, kept),
            "second_differs": not torch.equal(first[0], second[0]),
            "second_is_eager": _equal(second, eager_b),
            "uT": dist_out[0].numpy()}


# the entry points run at the switch's default and with it off
ENTRY_POINTS = ("distributed_run", "run", "step", "run_chunk", "adaptive")


def _entry_points(mesh) -> dict:
    """name -> (model, call): a whole model's 2-D `distributed_run`, a
    model born row-partitioned's `run`, `step` and `run_chunk` (2 steps,
    a program of its own), and an adaptive whole model's
    `distributed_run`."""
    whole, adaptive = _model("delta_32"), _model("adaptive_f64_32")
    born = _model("delta_32", mesh, "rows", 8)
    return {
        "distributed_run": (whole, lambda: distributed_run(
            whole, min_local=8, layout="2d")),
        "run": (born, lambda: born.run(warn=False)),
        "step": (born, lambda: born.step(born.u0)),
        "run_chunk": (born, lambda: born.run_chunk(born.u0, 2)),
        "adaptive": (adaptive, lambda: distributed_run(
            adaptive, min_local=8, layout="rows")),
    }


def _default_and_off(mesh) -> dict:
    """Each entry point eagerly, then as a rank on its card under NCCL
    runs it (`_as_on_card`), first at the module's default of
    `CAPTURE_NCCL` (on), then with it off: {"default": the switch as
    this rank found it, name: every rank's {"on": checks, "off":
    checks}}."""
    out = {"default": distributed.CAPTURE_NCCL}

    def checks(model, call, switch):
        eager, want, got, counts, _, fake = _eager_and_replayed(
            model, call, switch)
        return {"bits": _equal(eager, got), "counts": counts == want,
                "compiled": model.last_run_compiled,
                "reason": model.last_run_reason, "captures": fake.captures}

    for name, (model, call) in _entry_points(mesh).items():
        out[name] = _all_ranks({"on": checks(model, call, None),
                                "off": checks(model, call, False)})
    return out


def rank_cases(cases, units: bool) -> dict:
    """One rank: every case, and with `units` the key, unwaited and
    switch checks."""
    torch.set_num_threads(1)
    _log_transports()
    mesh = make_mesh()
    out = {case: _case(mesh, *case) for case in cases}
    if units:
        out["keys"] = _keys(mesh)
        out["unwaited"] = _unwaited(mesh)
        out["switch"] = _default_and_off(mesh)
        out["gathers"] = _all_ranks(_gathers_from_static(mesh))
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
    # an adaptive solve (Jacobi's too): its norm sits in a WHILE body
    adaptive = _model(name).solver.cycle_mode not in ("fixed", "fmg")
    for rank, c in enumerate(checks):
        assert c["bits"], f"rank {rank}: replay differs from eager"
        assert c["counts"], f"rank {rank}: counts differ from eager"
        assert c["trips"] == checks[0]["trips"], "trips differ by rank"
        assert c["collectives"] == checks[0]["collectives"]
        # captured on every rank, whatever the solver
        assert c["compiled"] and c["reason"] is None
        assert c["captures"] == 1, f"rank {rank}: not one capture"
        # every collective of a loop body took the peer transport, and
        # none outside one
        moved = c["transports"]
        assert moved["group_in_body"] == 0, moved
        assert moved["peer_outside_body"] == 0, moved
        assert (moved["peer"] > 0) == adaptive, moved
        assert (c["body_collectives"] > 0) == adaptive, c
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


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_switch_on_captures_under_nccl(spawned, entry):
    """With `CAPTURE_NCCL` on (the default), a rank on its card under
    NCCL captures the call once and its replay equals the eager run to
    the bit with equal LAUNCHES and COLLECTIVES, an adaptive solve too
    (its WHILE bodies' collectives on the peer transport)."""
    assert len(spawned[2]["switch"][entry]) == 2
    for rank, c in enumerate(spawned[2]["switch"][entry]):
        on = c["on"]
        assert on["bits"], f"rank {rank}: differs from its eager run"
        assert on["counts"], f"rank {rank}: counts differ from eager"
        assert on["compiled"] and on["reason"] is None
        assert on["captures"] == 1, f"rank {rank}: not one capture"


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_default_is_captured(spawned, entry):
    """The module's default, as every spawned rank finds it, is on: the
    calls above ran at it, each captured once on every rank."""
    assert spawned[2]["switch"]["default"] is True
    for rank, c in enumerate(spawned[2]["switch"][entry]):
        got = c["on"]
        assert got["compiled"] and got["reason"] is None, f"rank {rank}"
        assert got["captures"] == 1, f"rank {rank}"


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_switch_off_runs_eagerly(spawned, entry):
    """With `CAPTURE_NCCL` set off the same calls are eager on every rank
    with the switch's reason, and equal to their eager runs."""
    for rank, c in enumerate(spawned[2]["switch"][entry]):
        got = c["off"]
        assert not got["compiled"] and got["captures"] == 0
        assert "CAPTURE_NCCL" in got["reason"], got["reason"]
        assert got["bits"] and got["counts"], f"rank {rank}"


def test_gather_copies_the_programs_static_output(spawned):
    """A partitioned program's uT is gathered straight out of its static
    output, with no clone of the block beside the whole field (what
    n=32768 on four cards lacked), and what the call returns is its own:
    the first run's uT and stats outlive the next replay, the second run
    from another input equals its eager run to the bit on every rank,
    and distributed_run meets the JAX package's."""
    ranks = spawned[2]["gathers"]
    assert len(ranks) == 2
    for rank, got in enumerate(ranks):
        assert got["compiled"], f"rank {rank}"
        assert all(got["received_static"]), (rank, got["received_static"])
        assert got["first_kept"] and got["second_differs"], f"rank {rank}"
        assert got["second_is_eager"], f"rank {rank}"
    assert np.array_equal(ranks[0]["uT"], ranks[1]["uT"])
    juT, _ = _jax_dist("delta_32", 2, 8)
    np.testing.assert_allclose(ranks[0]["uT"], juT, rtol=0,
                               atol=BOUNDS["delta_32"])


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
    CUDA tensors, the staging reason; NCCL with CAPTURE_NCCL on (the
    default), None for every model, fixed-cycle, FMG and adaptive alike
    (the rule reads no solver); with it off, the switch's reason for
    every model."""
    parted = _model("delta_32", Mesh(2, 0), "rows", 8)
    models = [parted, _model("adaptive_f64_32", Mesh(2, 0), "rows", 8),
              _model("fmg_32", Mesh(2, 0), "rows", 8)]
    assert distributed.CAPTURE_NCCL
    assert parted.eager_reason() == CPU_REASON
    assert capture_reason(Mesh(2, 0), "cpu") == CPU_REASON
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CAPTURE", StandIn())
        assert capture_reason(Mesh(1), "cuda") is None
        mp.setattr(Mesh, "backend", property(lambda self: "gloo"))
        assert "under gloo" in capture_reason(Mesh(2, 0), "cuda")
        for model in models:
            model.device = torch.device("cuda")
            assert ("stage CUDA tensors through the host"
                    in model.eager_reason())
        mp.setattr(Mesh, "backend", property(lambda self: "nccl"))
        for world in (2, 4):
            assert capture_reason(Mesh(world, 0), "cuda") is None
        for model in models:
            assert model.eager_reason() is None
        mp.setattr(distributed, "CAPTURE_NCCL", False)
        assert "CAPTURE_NCCL" in capture_reason(Mesh(2, 0), "cuda")
        for model in models:
            assert "CAPTURE_NCCL" in model.eager_reason()
        assert capture_reason(Mesh(1), "cuda") is None


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
