"""The peer transport's kernels against NCCL on four cards, in turns
between trees of the port: each turn spawns four NCCL ranks (one a card)
from one tree's package, sets its peer transport up, and times a call of
each collective in a CUDA graph of `--calls` calls (the replay by CUDA
events, after a barrier, rank 0, the median of `--reps` replays) on the
peer kernels and on NCCL, at the shapes of main's float64 adaptive run at
n=1024 over four ranks: level 0's deep halo of (u, rhs) by rows, (264,
1152) with k=8; level 0's four edges in the 2-D layout, (528, 576); and
the gather of one float64 value.  Before timing, each case runs once
eagerly on both transports, which must agree to the bit on every rank.
With `--runs`, each turn also runs that float64 adaptive run (n=1024, 100
steps, min_local 64, built whole) through `distributed_run` in each
layout, captured at the default: after the capture's call, `--reps`
replays timed on rank 0 by the host clock after a barrier, each ending in
`torch.cuda.synchronize()`, with the program's top and body nodes and
uT's SHA-256, which must be the same in every turn.

    python3 scripts/torch_peer_turns.py [--tree c=.] [--tree p=DIR ...]
        [--turns cppc] [--calls 100] [--reps 5] [--runs]

A tree is a directory holding the package (a `git archive` of another
commit, or a copy with another design of a kernel); the first is this
checkout, named "c".  Each turn is one subprocess, so two trees' packages
never meet in one process.  Prints a line a turn and the medians a tree,
the card's name and power limit, then one JSON object.  Needs four CUDA
devices: with fewer it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import _turns

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEEP, K, EDGES = (264, 1152), 8, (528, 576)
WORLD = 4
DEADLINE_S = 360


def _graph_us(fn, x, calls: int, reps: int) -> list[float]:
    """µs a call of fn(x) in a captured graph of `calls` calls, for each
    of `reps` replays."""
    import torch
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch.utils import graphs

    def many(y):
        out = None
        for _ in range(calls):
            out = fn(y)
        return out

    programs = graphs.Programs()
    programs("calls", many, (x,))
    got = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        dist.barrier()
        torch.cuda.synchronize()
        start.record()
        programs("calls", many, (x,))
        end.record()
        end.synchronize()
        got.append(start.elapsed_time(end) / calls * 1e3)
    return got


def _flat(out) -> list:
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _runs(reps: int) -> dict:
    """The float64 adaptive run in each layout, captured: rank 0's replay
    walls, the program's nodes, uT's SHA-256 (module docstring)."""
    import gc
    import hashlib
    import time

    import torch
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import distributed_run

    res = {}
    for layout in ("rows", "2d"):
        model = AdvectionDiffusion(ProblemConfig(n=1024, num_steps=100),
                                   SolverConfig(dtype=torch.float64),
                                   device="cuda")
        kw = dict(min_local=64, layout=layout)
        first, _ = distributed_run(model, **kw)
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            uT, _ = distributed_run(model, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        program = model.programs.last
        shas = {hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                for t in (first, uT)}
        res[f"f64 adaptive, {layout}"] = {
            "walls": walls, "nodes": program.nodes,
            "body_nodes": program.body_nodes, "sha": sorted(shas)}
        # a rank holding captured graphs does not leave the group
        model = program = first = uT = None
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _rank(calls: int, reps: int, runs: bool = False) -> dict:
    import torch
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch.ops.cuda import peer
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed,
        halo,
        make_mesh,
        rows_halo,
    )

    mesh = make_mesh()
    dev = torch.device("cuda", torch.cuda.current_device())
    links = distributed.connect(mesh, dev, 1 << 20)
    r, f64 = mesh.rank, torch.float64
    gen = torch.Generator().manual_seed(r)
    before = r - 1 if r > 0 else None
    after = r + 1 if r < mesh.world - 1 else None
    up, down, left, right = mesh.neighbors
    out = torch.empty(mesh.world, dtype=f64, device=dev)
    cases = {
        f"deep halo {DEEP} x2, k={K}": (
            lambda x: distributed._peer_exchange(
                links, [x, x], K, [(0, before, after)]).wait(),
            lambda x: rows_halo.exchange([x, x], K, mesh), DEEP),
        f"four edges {EDGES}": (
            lambda x: distributed._peer_exchange(
                links, [x], 1, [(0, up, down), (1, left, right)]).wait(),
            lambda x: halo._start_halo(x, mesh).wait(), EDGES),
        "gather of one float64": (
            lambda y: [peer.gather(links, y[0], out) or out],
            lambda y: [torch.stack(distributed.all_gather_blocks(y, mesh))
                       .reshape(-1)], (1,)),
    }
    res = {}
    for name, (own, nccl, shape) in cases.items():
        x = torch.randn(shape, generator=gen, dtype=f64).to(dev)
        a, b = _flat(own(x)), _flat(nccl(x))
        equal = len(a) == len(b) and all(
            torch.equal(s.reshape(-1), t.reshape(-1)) for s, t in zip(a, b))
        everyone = [None] * mesh.world
        dist.all_gather_object(everyone, equal)
        res[name] = {"equal": everyone,
                     "peer": _graph_us(own, x, calls, reps),
                     "nccl": _graph_us(nccl, x, calls, reps)}
    links.close()
    if runs:
        res["runs"] = _runs(reps)
    return res


def _one(tree: str, calls: int, reps: int, runs: bool) -> None:
    """One turn, in this process: the ranks from `tree`'s package."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    res = launch_local(_rank, WORLD, (calls, reps, runs), backend="nccl",
                       device="cuda", deadline=DEADLINE_S)
    print(json.dumps(res))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR, a tree holding the package")
    parser.add_argument("--turns", default="cppc")
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--runs", action="store_true",
                        help="also time the float64 adaptive run's replays")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        _one(args.one, args.calls, args.reps, args.runs)
        return
    import torch

    if torch.cuda.device_count() < WORLD:
        sys.exit(f"torch_peer_turns: needs {WORLD} CUDA devices")
    trees = {"c": str(ROOT)}
    for spec in args.tree:
        name, _, where = spec.partition("=")
        trees[name] = where
    smi = _turns.card()

    def show(res):
        runs = res.get("runs", {})
        return "; ".join(
            [f"{case}: peer {statistics.median(g['peer']):.2f} µs, NCCL "
             f"{statistics.median(g['nccl']):.2f} µs"
             for case, g in res.items() if case != "runs"]
            + [f"{case}: replay {statistics.median(g['walls']):.5f} s "
               f"{[round(w, 5) for w in g['walls']]}, {g['nodes']} top / "
               f"{g['body_nodes']} body nodes" for case, g in runs.items()])

    turns = _turns.take_turns(
        args.turns, lambda name: [
            sys.executable, __file__, "--one", trees[name], "--calls",
            str(args.calls), "--reps", str(args.reps)]
        + (["--runs"] if args.runs else []), show, DEADLINE_S + 60)
    shas = {}
    for name, res in turns:
        for case, got in res.get("runs", {}).items():
            seen = shas.setdefault(case, got["sha"])
            if len(got["sha"]) != 1 or got["sha"] != seen:
                sys.exit(f"turn {name}: {case}: uT {got['sha']}, another "
                         f"turn's {seen}")
        for case, got in res.items():
            if case != "runs" and not all(got["equal"]):
                sys.exit(f"turn {name}: {case}: the peer kernels differ "
                         f"from NCCL, per rank {got['equal']}")
    summary = _turns.by_tree(turns)
    for name, cases in summary.items():
        runs = cases.pop("runs", {})
        print(f"tree {name} ({trees[name]}), median over its turns: "
              + "; ".join(f"{case}: peer {v['peer']:.2f} µs, NCCL "
                          f"{v['nccl']:.2f} µs" for case, v in cases.items()))
        if runs:
            print(f"tree {name}, replays, median over its turns: "
                  + "; ".join(f"{case}: {v['walls']:.5f} s, "
                              f"{v['body_nodes']} body nodes"
                              for case, v in runs.items()))
        cases["runs"] = runs
    if shas:
        print("uT equal in every turn (SHA-256): " + json.dumps(shas))
    print("; ".join(smi))
    print(json.dumps({"cards": smi, "calls": args.calls, "reps": args.reps,
                      "turns": args.turns, "trees": trees,
                      "medians": summary}))

if __name__ == "__main__":
    main()
