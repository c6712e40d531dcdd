"""The compiled loops' replays on one card, in turns between trees of the
port: each turn (one subprocess a turn, so two trees' packages never meet
in one process) builds its tree's kernels, then for each case captures
the run once and times `--reps` replays by the host clock, each ending in
`torch.cuda.synchronize()`, and reads the graph's CUDA-event time once:

  * `tol 1e-5`: AdvectionDiffusion n=1024, SolverConfig(tol=1e-5), 10
    steps (50 cycles a step, the GS coarse solve nested: 1510 tests);
  * `f64`: SolverConfig(dtype=float64), 100 steps (one cycle a step);
  * `dense`: SolverConfig(tol=1e-5, coarse_mode="dense"), 14 steps;
  * `poisson gs`: Poisson(n=256).solve("gs", max_iters=100000,
    check_every=100) (1001 tests), as chip_smoke.py's phase 18 (b);
  * `main`: the main path (no WHILE node), n=1024, 100 steps,
    bench.py's delta form with certify_every=10.

Each case reports the median replay wall (`walls`), the graph's ms, the
top, WHILE and body nodes, the while_set launches a replay and the SHA-256
of its outputs, which must be the same in every turn of every tree.  The
turn loop and the medians are `_turns.py`'s.

    python3 scripts/torch_loop_turns.py --parent DIR [--turns pccp]
        [--reps 5]

DIR holds another tree of the package (a `git archive` of the parent
commit under an ignored directory).  Prints a line a turn and the
medians a tree, the card's name and power limit, then one JSON object.
Needs a CUDA device: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import sys

import _turns

ROOT = pathlib.Path(__file__).resolve().parents[1]
TURN_S = 900


def _sha(out) -> str:
    import torch
    from torch.utils._pytree import tree_flatten

    digest = hashlib.sha256()
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor):
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()[:16]


def _cases():
    """(name, owner, call) for each case, the owner holding `programs`."""
    import torch

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.models import (
        AdvectionDiffusion,
        Poisson,
    )

    def advection(steps, **kw):
        model = AdvectionDiffusion(ProblemConfig(n=1024, num_steps=steps),
                                   SolverConfig(**kw), device="cuda")
        return model, lambda: model.run(warn=False)

    poisson = Poisson(n=256, device="cuda")
    main = AdvectionDiffusion(
        ProblemConfig(n=1024, num_steps=100),
        SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                     tol=1e-6, cycle_mode="fixed", num_cycles=1,
                     coarse_mode="dense", delta_form=True,
                     certify_every=10), device="cuda")
    yield ("tol 1e-5", *advection(10, tol=1e-5))
    yield ("f64", *advection(100, dtype=torch.float64))
    yield ("dense", *advection(14, tol=1e-5, coarse_mode="dense"))
    yield ("poisson gs", poisson, lambda: poisson.solve(
        "gs", max_iters=100_000, check_every=100))
    yield ("main", main, lambda: main.run(warn=False))


def _graph_ms(program) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    program.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _one(tree: str, reps: int) -> None:
    """One turn, in this process, on `tree`'s package."""
    import time

    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch

    from hpcclassmultigridproject_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for name, owner, call in _cases():
        first = call()
        torch.cuda.synchronize()
        program = owner.programs.last
        walls = []
        for _ in range(reps):
            cuda.reset_launches()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res[name] = {"walls": walls, "graph_ms": _graph_ms(program),
                     "nodes": program.nodes,
                     "whiles": len(program.loops),
                     "body_nodes": program.body_nodes,
                     "while_set": cuda.LAUNCHES["while_set"],
                     "sha": _sha(out), "first_sha": _sha(first)}
        owner.programs = type(owner.programs)()
        torch.cuda.empty_cache()
    print(json.dumps(res))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="a directory holding another tree of the "
                             "package")
    parser.add_argument("--turns", default="pccp")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        _one(args.one, args.reps)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_loop_turns: needs a CUDA device")
    trees = {"c": str(ROOT), "p": args.parent}
    smi = _turns.card()
    turns = _turns.take_turns(
        args.turns, lambda name: [
            sys.executable, __file__, "--parent", args.parent, "--one",
            trees[name], "--reps", str(args.reps)],
        lambda res: "; ".join(
            f"{case}: {statistics.median(g['walls']):.5f} s (graph "
            f"{g['graph_ms']:.2f} ms), {g['nodes']} top / {g['whiles']} "
            f"WHILE / {g['body_nodes']} body nodes, while_set "
            f"{g['while_set']}" for case, g in res.items()), TURN_S)
    shas = {}
    for name, res in turns:
        for case, got in res.items():
            seen = shas.setdefault(case, got["sha"])
            if got["sha"] != seen or got["first_sha"] != seen:
                sys.exit(f"turn {name}: {case}: outputs {got['sha']} / "
                         f"{got['first_sha']}, another turn's {seen}")
    summary = _turns.by_tree(turns)
    for name, cases in summary.items():
        print(f"tree {name} ({trees[name]}), median over its turns: "
              + "; ".join(f"{case}: {v['walls']:.5f} s, graph "
                          f"{v['graph_ms']:.2f} ms, {v['body_nodes']} body "
                          f"nodes" for case, v in cases.items()))
    print("outputs equal in every turn (SHA-256): " + json.dumps(shas))
    print("; ".join(smi))
    print(json.dumps({"cards": smi, "reps": args.reps, "turns": args.turns,
                      "trees": trees, "loops": summary}))

if __name__ == "__main__":
    main()
