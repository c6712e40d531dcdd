"""How far a partitioned run's capture gets on four cards, one NCCL rank a
card, and where each rank's device memory stands at each stage: the
delta-form run at n (chip_smoke.py's phase 19 (d): the configuration of
phase 13 (b) at a fixed cycle count), born partitioned in a layout,
captured (the default under NCCL) at the first call and replayed at the
second.

    python3 scripts/torch_capture_progress.py [--n 16384] [--layout 2d]
        [--cycles 5] [--deadline 240] [--out DIR]

Every rank notes, with the seconds since its start, each stage: the
model built, the warm-up's start and end, the capture's start and end
(with the top nodes), the instantiation's start and end, each replay's
start and end, and the gather of uT after it (`parallel.fetch_outputs`),
and rank 0 every 200th halo exchange (`start_exchange`, counted in
`distributed`, `halo` and `blocks`) with whether it was being captured.
At each stage a rank notes its memory, in MiB: free and total
(`torch.cuda.mem_get_info`), allocated and reserved, the reserved and
allocated bytes of the model's graph pool (`MemPool.snapshot`; `-`
before the pool exists), and the allocator's `num_alloc_retries` and
`num_ooms`.  Each line is printed with its rank, is the rank's
`distributed.note` (which a missed `--deadline` names, rank by rank) and
is appended as one JSON object to `DIR/capture_progress_rank<r>.jsonl`
(default `_scratch_progress/`), which outlives a killed rank.  A rank
that raises prints its exception with its rank (`launch_local`).  The
last line of standard output is one JSON object: the card's name and
power limit, and the center of uT (and whether the replay's equals the
first call's) or the error.  Needs four CUDA devices: with fewer it
exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS = 10
EVERY = 200  # exchanges between two notes
MIB = 2.0 ** 20


def _pool_mib(programs) -> tuple:
    """(reserved, allocated) MiB of a `Programs`' graph pool, or None
    before it exists."""
    pool = getattr(programs, "_pool", None)
    if pool is None:
        return None, None
    try:
        segments = pool[0].snapshot()
    except (AttributeError, TypeError):  # a torch without MemPool.snapshot
        segments = [s for s in torch.cuda.memory_snapshot()
                    if tuple(s.get("segment_pool_id", ())) == pool[0].id]
    return (sum(s["total_size"] for s in segments) / MIB,
            sum(s["allocated_size"] for s in segments) / MIB)


def memory(programs) -> dict:
    """This rank's device memory as it stands, in MiB (module
    docstring)."""
    free, total = torch.cuda.mem_get_info()
    stats = torch.cuda.memory_stats()
    pool_reserved, pool_allocated = _pool_mib(programs)
    return {"free": free / MIB, "total": total / MIB,
            "allocated": torch.cuda.memory_allocated() / MIB,
            "reserved": torch.cuda.memory_reserved() / MIB,
            "pool_reserved": pool_reserved,
            "pool_allocated": pool_allocated,
            "alloc_retries": stats.get("num_alloc_retries", 0),
            "ooms": stats.get("num_ooms", 0)}


def _mib(v) -> str:
    return "-" if v is None else f"{v:.0f}"


def _rank(n: int, layout: str, cycles: int, out_dir: str) -> dict:
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch import parallel
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import (
        blocks,
        distributed,
        distributed_run,
        halo,
        make_mesh,
    )
    from hpcclassmultigridproject_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    mesh = make_mesh()
    count = [0]
    held = {"programs": None}
    log = pathlib.Path(out_dir) / f"capture_progress_rank{mesh.rank}.jsonl"
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text("")

    def note(what: str, mem: bool = True) -> None:
        at = time.perf_counter() - t0
        rec = {"rank": mesh.rank, "stage": what, "s": round(at, 2)}
        line = f"rank {mesh.rank}: {what} at {at:.1f} s"
        if mem:
            m = memory(held["programs"])
            rec.update(m)
            line += (f"; MiB free {_mib(m['free'])} of {_mib(m['total'])}, "
                     f"allocated {_mib(m['allocated'])}, reserved "
                     f"{_mib(m['reserved'])}, pool reserved "
                     f"{_mib(m['pool_reserved'])} / allocated "
                     f"{_mib(m['pool_allocated'])}; alloc retries "
                     f"{m['alloc_retries']}, ooms {m['ooms']}")
        print(line, flush=True)
        with log.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        distributed.note(line)

    exchange = distributed.start_exchange

    def counted(*args, **kwargs):
        count[0] += 1
        if count[0] % EVERY == 0 and mesh.rank == 0:
            note(f"exchange {count[0]} (capturing "
                 f"{torch.cuda.is_current_stream_capturing()})", mem=False)
        return exchange(*args, **kwargs)

    for module in (distributed, blocks, halo):
        module.start_exchange = counted
    cap = graphs.CAPTURE
    warm_up, capture = cap.warm_up, cap.capture
    cuda_graph = torch.cuda.CUDAGraph
    instantiate, replay = cuda_graph.instantiate, cuda_graph.replay
    fetch = parallel.fetch_outputs

    def noted_warm_up(*args, **kwargs):
        note("warm-up start")
        warm_up(*args, **kwargs)
        note(f"warm-up done, {count[0]} exchanges")

    def noted_capture(*args, **kwargs):
        note("capture start")
        out = capture(*args, **kwargs)
        note(f"capture and instantiation done, {count[0]} exchanges, "
             f"{out[2]} top nodes")
        return out

    def noted_instantiate(self):
        note("capture ended, instantiation start")
        instantiate(self)
        torch.cuda.synchronize()
        note("instantiated")

    def noted_replay(self):
        note("replay start")
        replay(self)
        torch.cuda.synchronize()
        note("replay done")

    def noted_fetch(*args, **kwargs):
        note("gather of uT start")
        out = fetch(*args, **kwargs)
        torch.cuda.synchronize()
        note("gather of uT done")
        return out

    cap.warm_up, cap.capture = noted_warm_up, noted_capture
    cuda_graph.instantiate, cuda_graph.replay = noted_instantiate, noted_replay
    parallel.fetch_outputs = noted_fetch
    note("start")
    solver = SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                          tol=1e-6, cycle_mode="fixed", num_cycles=cycles,
                          coarse_mode="dense", delta_form=True,
                          certify_every=10)
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=STEPS), solver,
                               device="cuda", mesh=mesh, layout=layout)
    held["programs"] = model.programs
    torch.cuda.synchronize()
    note("built")
    centers = []
    for k in range(2):
        dist.barrier()
        t1 = time.perf_counter()
        uT, _ = distributed_run(model)
        torch.cuda.synchronize()
        note(f"call {k + 1} done in {time.perf_counter() - t1:.3f} s, "
             f"compiled {model.last_run_compiled}")
        # a whole field of n=32768 a rank: one at a time beside the pool
        centers.append(float(uT[n // 2, n // 2]))
        uT = None
    # the wrappers above live on global objects: the model and its graphs
    # (NCCL's kernels in them) go before the process group is left
    held["programs"] = model = None
    gc.collect()
    note("the model and its graphs dropped")
    return {"center": centers[0], "replay_equal": centers[0] == centers[1]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=16384)
    parser.add_argument("--layout", default="2d", choices=("rows", "2d"))
    parser.add_argument("--cycles", type=int, default=5)
    parser.add_argument("--deadline", type=float, default=240.0)
    parser.add_argument("--out", default=str(ROOT / "_scratch_progress"),
                        help="directory of the per-rank JSON lines")
    args = parser.parse_args(argv)
    if torch.cuda.device_count() < 4:
        sys.exit("torch_capture_progress: needs four CUDA devices")
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    out = {"cards": smi, "n": args.n, "layout": args.layout,
           "cycles": args.cycles}
    try:
        out.update(launch_local(_rank, 4, (args.n, args.layout,
                                           args.cycles, args.out),
                                backend="nccl", device="cuda",
                                deadline=args.deadline))
    except Exception as err:  # printed, then the script fails
        out["error"] = f"{type(err).__name__}: {err}"
        print(json.dumps(out))
        raise
    print(json.dumps(out))


if __name__ == "__main__":
    main()
