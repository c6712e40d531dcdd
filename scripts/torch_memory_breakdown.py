"""Where the device memory of the port's delta-form run goes, on one card:
the peak of each part of the run, from `torch.cuda.max_memory_allocated`
reset at each part's start.

    python3 scripts/torch_memory_breakdown.py [--n 16384] [--steps 10]

The configuration is chip_smoke.py's phase 13 (b): the delta form,
float32 cycles, float64 state and certificates, `certify_every=10`, the
auto cycle count, the model built on the device (auto from n=4096).  The
run is `AdvectionDiffusion.run_chunk` (the timestepper itself), whose
parts are marked by wrapping the names `mg/delta.py` calls:

- build: the model's constructor (levels, fine_hi, u0);
- opening: K1 (`fused_accumulate_open`), each step;
- cycle: one V-cycle (`mg_cycle`), each of the step's cycles;
- after cycle: the step's two norms and the bookkeeping up to the next
  part;
- f64 certificate: `_certify_hi`, every `certify_every`-th step;
- epilogue: after the last certificate, the float64 fold of the last
  correction, its residuals and norms;
- fetch: `parallel.fetch` of the padded float64 uT over a one-rank row
  partition, which is the assembly's copies alone (over W ranks the
  all-gather's W blocks come on top: one whole field more);
- crop: the logical (n+1)^2 uT (a view).

Each part prints the memory held when it starts ("held") and its peak;
the persistent fields print their bytes.  One JSON line at the end, with
the card's name and power limit.  Needs a CUDA device: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

MIB = 2.0 ** 20


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors a level (or a list of levels) holds."""
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


class Parts:
    """Peak device memory per named part of a run: `start(name)` closes
    the part running (its peak since it started) and opens `name`."""

    def __init__(self):
        self.name, self.held = None, 0
        self.peaks = {}  # name -> [calls, max held at start, max peak]

    def start(self, name: str | None) -> None:
        torch.cuda.synchronize()
        if self.name is not None:
            rec = self.peaks.setdefault(self.name, [0, 0, 0])
            rec[0] += 1
            rec[1] = max(rec[1], self.held)
            rec[2] = max(rec[2], torch.cuda.max_memory_allocated())
        self.name, self.held = name, torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def wrap(self, module, attr: str, name: str, after: str) -> None:
        real = getattr(module, attr)

        def marked(*a, **k):
            self.start(name)
            out = real(*a, **k)
            self.start(after)
            return out

        setattr(module, attr, marked)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_memory_breakdown: no CUDA device")

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.mg import delta
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import (
        Mesh,
        RowBlocks,
        fetch,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    solver = SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                          tol=1e-6, cycle_mode="fixed", num_cycles=None,
                          coarse_mode="dense", delta_form=True,
                          certify_every=10)
    parts = Parts()
    parts.start("build")
    t0 = time.perf_counter()
    model = AdvectionDiffusion(ProblemConfig(n=args.n, num_steps=args.steps),
                               solver, device="cuda")
    build_s = time.perf_counter() - t0
    parts.start("run start")
    fields = {"levels": _tensor_bytes(model.levels),
              "level 0": _tensor_bytes(model.levels[0]),
              "fine_hi": _tensor_bytes(model.fine_hi),
              "u0": _tensor_bytes(model.u0)}

    parts.wrap(delta, "fused_accumulate_open", "opening", "after opening")
    parts.wrap(delta, "mg_cycle", "cycle", "after cycle")
    parts.wrap(delta, "_certify_hi", "f64 certificate", "epilogue")
    t0 = time.perf_counter()
    u, stats = model.run_chunk(model.u0, args.steps)
    parts.start(None)
    run_s = time.perf_counter() - t0
    rows, cols = u.shape
    part = RowBlocks(Mesh(1, 0), local=rows, rows=rows, cols=cols, halo=8)
    parts.start("fetch")
    whole = fetch(u, part)
    parts.start("crop")
    uT = model.crop(whole)
    parts.start(None)
    center = float(uT[args.n // 2, args.n // 2])

    out = {"n": args.n, "steps": args.steps,
           "num_cycles": model.solver.num_cycles,
           "padded": list(model.levels[0].padded),
           "build_s": build_s, "run_s": run_s, "center_uT": center,
           "final_rel_residual_hi": float(stats["final_rel_residual_hi"]),
           "fields_mib": {k: v / MIB for k, v in fields.items()},
           "parts_mib": {k: {"calls": c, "held": h / MIB, "peak": p / MIB,
                             "above_held": (p - h) / MIB}
                         for k, (c, h, p) in parts.peaks.items()},
           "card": smi}
    print(f"[memory] n={args.n} padded {out['padded']}, "
          f"{out['num_cycles']} cycles a step, {args.steps} steps; {smi}")
    for k, v in out["fields_mib"].items():
        print(f"[memory] field {k}: {v:.1f} MiB")
    for k, v in out["parts_mib"].items():
        print(f"[memory] {k} ({v['calls']} calls): held at its start "
              f"{v['held']:.1f} MiB, peak {v['peak']:.1f} MiB "
              f"(+{v['above_held']:.1f})")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
