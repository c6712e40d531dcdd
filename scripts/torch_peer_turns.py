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

    python3 scripts/torch_peer_turns.py [--tree c=.] [--tree p=DIR ...]
        [--turns cppc] [--calls 100] [--reps 5]

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
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEEP, K, EDGES = (264, 1152), 8, (528, 576)
WORLD = 4
DEADLINE_S = 240


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


def _rank(calls: int, reps: int) -> dict:
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
    return res


def _one(tree: str, calls: int, reps: int) -> None:
    """One turn, in this process: the ranks from `tree`'s package."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    res = launch_local(_rank, WORLD, (calls, reps), backend="nccl",
                       device="cuda", deadline=DEADLINE_S)
    print(json.dumps(res))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR, a tree holding the package")
    parser.add_argument("--turns", default="cppc")
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        _one(args.one, args.calls, args.reps)
        return
    import torch

    if torch.cuda.device_count() < WORLD:
        sys.exit(f"torch_peer_turns: needs {WORLD} CUDA devices")
    trees = {"c": str(ROOT)}
    for spec in args.tree:
        name, _, where = spec.partition("=")
        trees[name] = where
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    turns = []
    for name in args.turns:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", trees[name], "--calls",
             str(args.calls), "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=DEADLINE_S + 60)
        if proc.returncode:
            sys.exit(f"turn {name} ({trees[name]}) failed:\n"
                     f"{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, got in res.items():
            if not all(got["equal"]):
                sys.exit(f"turn {name}: {case}: the peer kernels differ "
                         f"from NCCL, per rank {got['equal']}")
        turns.append((name, res))
        print(f"turn {name}: " + "; ".join(
            f"{case}: peer {statistics.median(g['peer']):.2f} µs, NCCL "
            f"{statistics.median(g['nccl']):.2f} µs"
            for case, g in res.items()), flush=True)
    summary = {}
    for name in trees:
        mine = [res for n, res in turns if n == name]
        if not mine:
            continue
        summary[name] = {case: {
            kind: statistics.median(
                [v for res in mine for v in res[case][kind]])
            for kind in ("peer", "nccl")} for case in mine[0]}
    for name, cases in summary.items():
        print(f"tree {name} ({trees[name]}), median over its turns: "
              + "; ".join(f"{case}: peer {v['peer']:.2f} µs, NCCL "
                          f"{v['nccl']:.2f} µs" for case, v in cases.items()))
    print("; ".join(smi))
    print(json.dumps({"cards": smi, "calls": args.calls, "reps": args.reps,
                      "turns": args.turns, "trees": trees,
                      "us": summary}))


if __name__ == "__main__":
    main()
