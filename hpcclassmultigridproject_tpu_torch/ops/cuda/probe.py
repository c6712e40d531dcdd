"""P: the Hopper feature probe, `csrc/probe.cu`.

Six small float32 kernels, one per primitive a single-launch coarse tower
would need (the JAX package's `scripts/mosaic_probe_tpu.py`): stride-2
rows, a column-decimation product, row interleave, flatten, and row
decimation and row prolongation by product.  Each has a plain PyTorch
version; CUDA tensors launch the kernel, CPU tensors run the plain version.

    python -m hpcclassmultigridproject_tpu_torch.ops.cuda.probe [--device cpu]

prints the JAX script's `PASS name` / `FAIL name` lines and `PROBE DONE`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build

R, C = 64, 256  # the JAX probe's shape


def _launch(name: str, counter: str, out: torch.Tensor, *args) -> torch.Tensor:
    err = _build.entry(name)(*args,
                             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, f"{counter} kernel")
    cuda.LAUNCHES[counter] += 1
    return out


def _check(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: the probe kernels take contiguous 2-D "
                             f"float32, not {tuple(t.shape)} {t.dtype}")


def stride2_rows_plain(x):
    return x[::2].contiguous()


def stride2_rows(x):
    """x[::2, :]."""
    if not cuda.use_kernel(x):
        return stride2_rows_plain(x)
    _check(x=x)
    rows, cols = x.shape
    out = torch.empty((rows // 2, cols), dtype=x.dtype, device=x.device)
    return _launch("mg_probe_stride2_rows", "probe_stride2_rows", out,
                   x.data_ptr(), out.data_ptr(), rows, cols)


def interleave_rows_plain(x):
    return torch.stack([x, x + 1.0], dim=1).reshape(2 * x.shape[0], x.shape[1])


def interleave_rows(x):
    """stack([x, x + 1], 1).reshape(2R, C): x's rows, each followed by
    itself plus one."""
    if not cuda.use_kernel(x):
        return interleave_rows_plain(x)
    _check(x=x)
    rows, cols = x.shape
    out = torch.empty((2 * rows, cols), dtype=x.dtype, device=x.device)
    return _launch("mg_probe_interleave_rows", "probe_interleave_rows", out,
                   x.data_ptr(), out.data_ptr(), rows, cols)


def flatten_plain(x):
    """x's values in a fresh (R*C, 1) buffer: what the TPU kernel computes.
    `run_probe` gives its pallas_call no `input_output_aliases`
    (scripts/mosaic_probe_tpu.py:39-46), so `k_flatten` (:94-100) writes
    x's values into an output of its own; a view (`x.reshape(-1, 1)`) is
    another function, one that launches nothing."""
    return x.reshape(-1, 1).clone()


def flatten(x):
    """x.reshape(R*C, 1) as a copy: writing to the result leaves x as it
    was."""
    if not cuda.use_kernel(x):
        return flatten_plain(x)
    _check(x=x)
    out = torch.empty((x.numel(), 1), dtype=x.dtype, device=x.device)
    return _launch("mg_probe_flatten", "probe_flatten", out, x.data_ptr(),
                   out.data_ptr(), x.numel())


def dot_plain(a, b):
    return torch.matmul(a, b)


# Lanes that split k for each output of the product kernel (csrc/probe.cu,
# DOT_G).
DOT_LANES = 8


def dot_in_kernel_order(a, b):
    """a @ b summed in the product kernel's fixed order, so that its result
    can be held to the kernel's bit for bit: with L = ceil(k / 8), lane g
    sums a[:, q] * b[q, :] for q in [g L, (g+1) L) in increasing q from +0
    (each product rounded, then added: no FMA), and the eight partial sums
    combine as ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7)).  Past k
    a lane adds +0 products, as the kernel's zero-filled tile does."""
    (m, k), n = a.shape, b.shape[1]
    lanes = DOT_LANES
    span = -(-k // lanes)
    q = torch.arange(lanes, device=a.device)[:, None] * span + torch.arange(
        span, device=a.device)            # (lanes, span): lane g's range
    inside = q < k
    q = torch.where(inside, q, 0)
    a_q = torch.where(inside, a[:, q], 0.0)          # (m, lanes, span)
    b_q = torch.where(inside[..., None], b[q], 0.0)  # (lanes, span, n)
    s = torch.zeros((lanes, m, n), dtype=a.dtype, device=a.device)
    for j in range(span):
        s = s + a_q[:, :, j].T[:, :, None] * b_q[:, j][:, None, :]
    for d in (4, 2, 1):  # the shuffle tree: lane g adds lane g ^ d
        s = s[:d] + s[d:2 * d]
    return s[0]


def dot_error_bound(a, b):
    """The elementwise bound |fl(a @ b) - a @ b| <= k 2^-24 (|a| @ |b|) of a
    float32 product summed in any order, in float64."""
    a64, b64 = a.double(), b.double()
    return a.shape[1] * 2.0 ** -24 * (a64.abs() @ b64.abs())


# The three product probes' shapes (m, k, n), and one that no tile divides.
DOT_SHAPES = {"dot_decimate": (R, C, C // 2),
              "dot_decimate_rows": (R // 2, R, C),
              "dot_prolong_rows": (2 * R, R, C),
              "unaligned": (65, 257, 129)}


def dense_operands(m: int, k: int, n: int, seed: int = 0):
    """Dense float32 factors a (m, k), b (k, n) ~ N(0, 1) from `seed`."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def dot(a, b, counter: str):
    """a @ b by the kernel's own arithmetic (never cuBLAS): operands staged
    in shared memory, k split over eight lanes an output in the fixed order
    of `dot_in_kernel_order`; one of the three product probes, counted under
    `counter`."""
    if not cuda.use_kernel(a, b):
        return dot_plain(a, b)
    _check(a=a, b=b)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"dot: {tuple(a.shape)} @ {tuple(b.shape)}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    return _launch("mg_probe_dot", counter, out, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, k, n)


def probe_operands():
    """The JAX probe's inputs, in numpy: x ~ N(0, 1) of shape (R, C) from
    seed 0, the column decimation D = eye(C, C/2), the row decimation Dr
    (R/2, R) and the bilinear row prolongation P (2R, R)."""
    x = np.random.default_rng(0).standard_normal((R, C)).astype(np.float32)
    D = np.eye(C, C // 2, dtype=np.float32)
    Dr = np.zeros((R // 2, R), np.float32)
    Dr[np.arange(R // 2), 2 * np.arange(R // 2)] = 1.0
    P = np.zeros((2 * R, R), np.float32)
    P[2 * np.arange(R), np.arange(R)] = 1.0
    P[2 * np.arange(R - 1) + 1, np.arange(R - 1)] = 0.5
    P[2 * np.arange(R - 1) + 1, np.arange(R - 1) + 1] = 0.5
    return dict(x=x, D=D, Dr=Dr, P=P)


def probes():
    """{name: (kernel, plain version, operand names, numpy expectation,
    exact)}: exact probes must equal the expectation, the products be
    within atol 1e-6 of it (the JAX script's checks)."""
    return {
        "stride2_rows": (stride2_rows, stride2_rows_plain, ("x",),
                         lambda o: o["x"][::2, :], True),
        "dot_decimate": (lambda x, d: dot(x, d, "probe_dot_decimate"),
                         dot_plain, ("x", "D"),
                         lambda o: o["x"] @ o["D"], False),
        "interleave_rows": (interleave_rows, interleave_rows_plain, ("x",),
                            lambda o: np.stack([o["x"], o["x"] + 1.0], 1)
                            .reshape(2 * R, C), True),
        "flatten": (flatten, flatten_plain, ("x",),
                    lambda o: o["x"].reshape(-1, 1), True),
        "dot_decimate_rows": (
            lambda dr, x: dot(dr, x, "probe_dot_decimate_rows"), dot_plain,
            ("Dr", "x"), lambda o: o["Dr"] @ o["x"], False),
        "dot_prolong_rows": (
            lambda p, x: dot(p, x, "probe_dot_prolong_rows"), dot_plain,
            ("P", "x"), lambda o: o["P"] @ o["x"], False),
    }


def run_probes(device="cuda", reps: int = 100) -> list[dict]:
    """Run the six probes once each on `device` and hold each result to the
    numpy expectation.  One record per probe: name, passed, max_abs_diff
    (from the expectation), bit_identical (to the plain version on the same
    device), and on a CUDA device with `reps` > 0 kernel_ms, plain_ms and
    library_ms, each the card's time per call over `reps` calls
    (`utils.timing.device_ms`); None otherwise (on the CPU the kernel route
    is the plain version).  Each plain version is PyTorch's own form of the
    probe (a strided copy, stack and reshape, a reshape into a fresh buffer
    with `clone`, torch.matmul), so library_ms times it again on its own:
    the call a user would make in place of the kernel."""
    from hpcclassmultigridproject_tpu_torch.utils.timing import device_ms

    device = torch.device(device)
    ops = probe_operands()
    tens = {k: torch.from_numpy(v).to(device) for k, v in ops.items()}
    on_card = device.type == "cuda"
    records = []
    for name, (kern, plain, names, expect, exact) in probes().items():
        args = [tens[k] for k in names]
        got, want_plain = kern(*args), plain(*args)
        if on_card:
            torch.cuda.synchronize()
        got_np = got.cpu().numpy()
        want = expect(ops)
        diff = float(np.abs(got_np - want).max())
        passed = (got_np.shape == want.shape
                  and (np.array_equal(got_np, want) if exact
                       else bool(np.allclose(got_np, want, atol=1e-6))))
        rec = dict(name=name, passed=bool(passed), max_abs_diff=diff,
                   bit_identical=bool(torch.equal(got, want_plain)),
                   kernel_ms=None, plain_ms=None, library_ms=None)
        if on_card and reps:
            rec["kernel_ms"] = device_ms(lambda: kern(*args), reps)
            rec["plain_ms"] = device_ms(lambda: plain(*args), reps)
            rec["library_ms"] = device_ms(lambda: plain(*args), reps)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hpcclassmultigridproject_tpu_torch.ops.cuda.probe",
        description="the six Hopper feature probes (P)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("device 'cuda' but torch sees no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print(f"device: {device} (the plain versions)", flush=True)
    records = run_probes(device)
    for rec in records:
        print(f"{'PASS' if rec['passed'] else 'FAIL(values)'} {rec['name']}",
              flush=True)
    print("PROBE DONE", flush=True)
    return 0 if all(r["passed"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
