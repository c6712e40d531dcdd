"""P's six probe kernels of two trees of the PyTorch/CUDA port, timed in
turns on one card beside their library calls and an empty kernel.

    python3 scripts/torch_probe_turns.py --parent DIR [--order pccp]

DIR holds a copy of another commit of the repository (for example the
parent, unpacked with `git archive`).  Each turn is a fresh process that
imports `hpcclassmultigridproject_tpu_torch` from one tree (`p`: DIR, `c`:
this checkout), builds that tree's kernels, and prints one JSON line with
the card's time per call (`utils.timing.device_ms`, 200 calls, float32):

- each probe's kernel (`ops.cuda.probe.probes()`, on the JAX probe's
  operands) and its library call, the same in every turn: torch.matmul for
  the three products, `x[::2].contiguous()`, stack and reshape, and for
  flatten both the copy `x.reshape(-1, 1).clone()` (the function the TPU
  kernel computes: a fresh output) and the view `x.reshape(-1, 1)` (no
  launch);
- an empty kernel, one block of 32 threads and 256 blocks of 256 threads
  (the product kernel's grid at dot_decimate), built with the port's nvcc
  flags: the practical floor of these rows;
- the main path (AdvectionDiffusion, n=1024, 100 delta-form steps): the
  SHA-256 of its uT's bytes and the kernel launch calls of one run under
  torch.profiler (chip_smoke.py's `_profiled_run`).

Then a summary: per tree, the median of its turns, and whether every
turn's uT is the same to the bit.  The order defaults to parent, change,
change, parent, so drift of the card or the host shows.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
PROBES = ("stride2_rows", "dot_decimate", "interleave_rows", "flatten",
          "dot_decimate_rows", "dot_prolong_rows")
KEYS = tuple(f"{p}_ms" for p in PROBES) + (
    "empty_1x32_ms", "empty_256x256_ms", "main_launch_calls")
LIBRARY_KEYS = tuple(f"{p}_library_ms" for p in PROBES) + (
    "flatten_view_ms",)
EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int mg_empty(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the tree first on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _empty_kernel(build):
    """The empty kernel, built by nvcc with the port's flags into the
    package's build directory of this checkout."""
    out = HERE / "hpcclassmultigridproject_tpu_torch" / "_build"
    out.mkdir(exist_ok=True)
    src, lib = out / "empty_kernel.cu", out / "libempty_kernel.so"
    src.write_text(EMPTY_SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mg_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import hpcclassmultigridproject_tpu_torch as pkg
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, probe
    from hpcclassmultigridproject_tpu_torch.utils.timing import device_ms

    assert pathlib.Path(pkg.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), pkg.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _chip_smoke()
    _build.library()
    tens = {k: torch.from_numpy(v).cuda()
            for k, v in probe.probe_operands().items()}
    x = tens["x"]
    library = {
        "stride2_rows": lambda x: x[::2].contiguous(),
        "dot_decimate": torch.matmul,
        "interleave_rows": lambda x: torch.stack([x, x + 1.0], dim=1)
        .reshape(2 * x.shape[0], x.shape[1]),
        "flatten": lambda x: x.reshape(-1, 1).clone(),
        "dot_decimate_rows": torch.matmul,
        "dot_prolong_rows": torch.matmul,
    }
    out = {"root": root}
    for name, (kern, _, names, _, _) in probe.probes().items():
        args = [tens[k] for k in names]
        out[f"{name}_ms"] = device_ms(lambda: kern(*args), 200)
        out[f"{name}_library_ms"] = device_ms(
            lambda: library[name](*args), 200)
    out["flatten_view_ms"] = device_ms(lambda: x.reshape(-1, 1), 200)
    empty = _empty_kernel(_build)
    stream = torch.cuda.current_stream().cuda_stream
    for blocks, threads in ((1, 32), (256, 256)):
        out[f"empty_{blocks}x{threads}_ms"] = device_ms(
            lambda: _build.check(empty(blocks, threads, stream), "empty"),
            200)
    model = AdvectionDiffusion(ProblemConfig(n=1024, num_steps=100),
                               smoke.delta_config(certify_every=10),
                               device="cuda")
    uT, _ = model.run(warn=False)
    out["main_uT_sha256"] = hashlib.sha256(
        uT.cpu().numpy().tobytes()).hexdigest()
    _, _, out["main_launch_calls"], _ = smoke._profiled_run(
        lambda: model.run(warn=False))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return
    roots = {"p": str(pathlib.Path(args.parent).resolve()), "c": str(HERE)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[turns] card: {smi}; order {args.order}", flush=True)
    runs = {"p": [], "c": []}
    for turn in args.order:
        proc = subprocess.run(
            [sys.executable, __file__, "--parent", args.parent, "--measure",
             roots[turn]], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"turn {turn} failed:\n{proc.stderr}")
        rec = json.loads(proc.stdout.splitlines()[-1])
        runs[turn].append(rec)
        print(f"[turns] {turn}: " + ", ".join(
            f"{k} {rec[k]:.5f}" for k in KEYS + LIBRARY_KEYS), flush=True)
    summary = {tree: {k: statistics.median(r[k] for r in recs)
                      for k in KEYS + LIBRARY_KEYS}
               for tree, recs in runs.items() if recs}
    hashes = {r["main_uT_sha256"] for recs in runs.values() for r in recs}
    print(f"[turns] main path uT the same to the bit in every turn: "
          f"{len(hashes) == 1}", flush=True)
    print(json.dumps({"card": smi, "order": args.order, "median": summary,
                      "main_uT_bit_equal": len(hashes) == 1}))


if __name__ == "__main__":
    main()
