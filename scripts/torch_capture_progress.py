"""How far a partitioned run's capture gets on four cards, one NCCL rank a
card: the delta-form run at n (chip_smoke.py's phase 19 (d): the
configuration of phase 13 (b) at a fixed cycle count), born partitioned
in a layout, captured with `parallel.distributed.CAPTURE_NCCL` set in
the ranks and replayed twice.

    python3 scripts/torch_capture_progress.py [--n 16384] [--layout 2d]
        [--cycles 5] [--deadline 240]

Rank 0 prints, with the seconds since its start, the model built, the
warm-up's start and end, the capture's start and end (with the top
nodes and the MiB reserved), each replay, and every 200th halo exchange
(`start_exchange`, counted in `distributed`, `halo` and `blocks`) with
whether it was being captured; each line is also the rank's
`distributed.note`, which a missed `--deadline` names.  The last line
is one JSON object: the card's name and power limit, and the center of
uT or the error.  Needs four CUDA devices: with fewer it exits non-zero.
"""

from __future__ import annotations

import argparse
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


def _rank(n: int, layout: str, cycles: int) -> dict:
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
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

    def note(what: str) -> None:
        line = f"{what} at {time.perf_counter() - t0:.1f} s"
        if mesh.rank == 0:
            print(line, flush=True)
        distributed.note(line)

    exchange = distributed.start_exchange

    def counted(*args, **kwargs):
        count[0] += 1
        if count[0] % EVERY == 0:
            note(f"exchange {count[0]} (capturing "
                 f"{torch.cuda.is_current_stream_capturing()})")
        return exchange(*args, **kwargs)

    for module in (distributed, blocks, halo):
        module.start_exchange = counted
    cap = graphs.CAPTURE
    warm_up, capture = cap.warm_up, cap.capture

    def noted_warm_up(*args, **kwargs):
        note("warm-up start")
        warm_up(*args, **kwargs)
        note(f"warm-up done, {count[0]} exchanges")

    def noted_capture(*args, **kwargs):
        note("capture start")
        out = capture(*args, **kwargs)
        reserved = torch.cuda.memory_reserved() / 2**20
        note(f"capture and instantiation done, {count[0]} exchanges, "
             f"{out[2]} top nodes, {reserved:.0f} MiB reserved")
        return out

    cap.warm_up, cap.capture = noted_warm_up, noted_capture
    distributed.CAPTURE_NCCL = True
    solver = SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                          tol=1e-6, cycle_mode="fixed", num_cycles=cycles,
                          coarse_mode="dense", delta_form=True,
                          certify_every=10)
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=STEPS), solver,
                               device="cuda", mesh=mesh, layout=layout)
    torch.cuda.synchronize()
    note(f"built, {torch.cuda.memory_allocated() / 2**20:.0f} MiB")
    for k in range(2):
        dist.barrier()
        t1 = time.perf_counter()
        uT, _ = distributed_run(model)
        torch.cuda.synchronize()
        note(f"call {k + 1} done in {time.perf_counter() - t1:.3f} s, "
             f"compiled {model.last_run_compiled}")
    return {"center": float(uT[n // 2, n // 2])}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=16384)
    parser.add_argument("--layout", default="2d", choices=("rows", "2d"))
    parser.add_argument("--cycles", type=int, default=5)
    parser.add_argument("--deadline", type=float, default=240.0)
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
                                           args.cycles),
                                backend="nccl", device="cuda",
                                deadline=args.deadline))
    except Exception as err:  # printed, then the script fails
        out["error"] = f"{type(err).__name__}: {err}"
        print(json.dumps(out))
        raise
    print(json.dumps(out))


if __name__ == "__main__":
    main()
