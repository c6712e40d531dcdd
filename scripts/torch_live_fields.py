"""How many whole fields the delta-form run holds at once, part by part,
counted on the CPU: the peak bytes of live tensors a part of one step
makes, in float64 fields of level 0's padded shape.

    python3 scripts/torch_live_fields.py [--n 256] [--tree DIR]

The run is one step of phase 13 (b)'s configuration (the delta form,
float32 cycles, float64 state and certificates, 5 fixed V-cycles, the
dense coarse solve) with `certify_every=1`, so that the step runs the
float64 certificate and then the epilogue, on the CPU, through the plain
versions.  Every tensor an operation returns is counted from its
creation to its last reference (`TorchDispatchMode`, a weak reference
per tensor, storages counted once); the model's own fields, made before
the run, are not.  The parts are marked by wrapping the names
`mg/delta.py` calls: the opening (`fused_accumulate_open`), each cycle
(`mg_cycle`), the certificate (`_certify_hi`) and the epilogue after it.
On the card the cycles and the opening are kernels and hold less; the
certificate and the epilogue are these torch operations there too, and
their count times a field's bytes is what they ask of the device's
memory.  `--tree` imports the package from another checkout (a parent
unpacked under `_scratch_*`).  Prints one line a part, then one JSON
object.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import weakref

ROOT = pathlib.Path(__file__).resolve().parents[1]

PARTS = (("fused_accumulate_open", "opening", "after opening"),
         ("mg_cycle", "cycle", "after cycle"),
         ("_certify_hi", "f64 certificate", "epilogue"))


def live_fields(n: int = 256) -> dict:
    """{part: the most float64 fields of level 0's padded shape that the
    tensors made in it held at once} for one step at n (module
    docstring)."""
    import torch
    from torch.utils._pytree import tree_flatten
    from torch.utils._python_dispatch import TorchDispatchMode

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.mg import delta
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    live: dict = {}
    refs: collections.Counter = collections.Counter()
    state = {"bytes": 0, "part": "start"}
    peaks: dict = {}

    def dropped(ptr):
        refs[ptr] -= 1
        if refs[ptr] == 0:
            state["bytes"] -= live.pop(ptr)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    storage = t.untyped_storage()
                    ptr = storage.data_ptr()
                    if ptr not in live:
                        live[ptr] = storage.nbytes()
                        state["bytes"] += live[ptr]
                    refs[ptr] += 1
                    weakref.finalize(t, dropped, ptr)
            part = state["part"]
            peaks[part] = max(peaks.get(part, 0), state["bytes"])
            return out

    solver = SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                          tol=1e-6, cycle_mode="fixed", num_cycles=5,
                          coarse_mode="dense", delta_form=True,
                          certify_every=1)
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=1), solver,
                               device="cpu")
    field = model.u0.numel() * 8
    real = {name: getattr(delta, name) for name, _, _ in PARTS}

    def marked(name, part, after):
        def call(*args, **kwargs):
            state["part"] = part
            out = real[name](*args, **kwargs)
            state["part"] = after
            return out
        return call

    for name, part, after in PARTS:
        setattr(delta, name, marked(name, part, after))
    try:
        with Count():
            model.run_chunk(model.u0, 1)
    finally:
        for name in real:
            setattr(delta, name, real[name])
    return {part: b / field for part, b in peaks.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose package is counted")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    import torch

    torch.set_num_threads(2)
    fields = live_fields(args.n)
    for part, count in fields.items():
        print(f"[live fields] n={args.n} {part}: {count:.2f} float64 "
              "fields at once")
    print(json.dumps({"n": args.n, "tree": args.tree, "fields": fields}))


if __name__ == "__main__":
    main()
