"""The readings a cell's correctness limit is set from.

For each seed, the initial conditions that a run compares (the first
`check.runs` entries of the seed's bank) are run through

- "program": the cell's own solver, as the timed path runs it;
- "control": the program's own lower-precision path (the traffic file's
  "control" solver), which has to come out as not correct;
- "reference_f32": the plain reference computed in float32;

and each output is compared with the float64 reference from the same
initial condition, as the harness compares a run (`harness.check`).  The
benchmark's own runs do not run this.

    python3 mgbench/control.py --workload <cell> --seeds 1 2 3 [--kinds program control]

prints one JSON line a seed, with each kind's largest relative max-norm
gap, and the cell's limit.
"""

from __future__ import annotations

import math
import os
import sys

if __name__ == "__main__":
    # run as a script from the checkout's root: the root, not this folder,
    # goes on the path (`mgbench.trace`, not the standard library's trace)
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != _HERE]
    sys.path.insert(0, os.path.dirname(_HERE))

import torch  # noqa: E402

from mgbench import harness, spec, traffic  # noqa: E402
from mgbench.reference import cn  # noqa: E402

KINDS = ("program", "control", "reference_f32")


def _model(cell: spec.Cell, solver: dict, device):
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    return AdvectionDiffusion(harness.problem_config(cell.config),
                              harness.solver_config(solver), device=device)


def readings(cell: spec.Cell, seeds, kinds=KINDS, device="cuda") -> list:
    """[{seed, kind: gap, ...}] for each seed."""
    device = torch.device(device)
    c = cell.config
    models = {"program": cell.traffic["solver"],
              "control": cell.traffic["control"]["solver"]}
    models = {k: _model(cell, s, device) for k, s in models.items()
              if k in kinds}
    out = []
    for seed in seeds:
        bank = traffic.gaussian_bank(seed, c, cell.traffic["inputs"], device)
        row = {"seed": seed}
        for j in range(min(cell.traffic["check"]["runs"], len(bank))):
            u0 = bank[j]
            ref = cn.cn_run(u0, c["n"], c["nu"], harness.time_step(c),
                            c["num_steps"], c["kx"], c["ky"])
            outs = {}
            for kind, model in models.items():
                uT, _ = model.run(model.pad(u0.to(model.u0.dtype)),
                                  warn=False)
                outs[kind] = uT
            if "reference_f32" in kinds:
                outs["reference_f32"] = cn.cn_run(
                    u0, c["n"], c["nu"], harness.time_step(c),
                    c["num_steps"], c["kx"], c["ky"], dtype=torch.float32)
            scale = float(ref.abs().max())
            for kind, uT in outs.items():
                gap = float((uT.to(torch.float64) - ref).abs().max()) / scale
                gap = gap if math.isfinite(gap) else math.inf
                row[kind] = max(row.get(kind, 0.0), gap)
        out.append(row)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="the readings of a cell's limit")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: torch sees no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    limit = cell.limits["uT_rel_gap"]["limit"]
    for row in readings(cell, args.seeds, args.kinds):
        row.update(workload=cell.name, limit=limit)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
