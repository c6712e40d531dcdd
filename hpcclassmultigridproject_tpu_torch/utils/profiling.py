"""Per-phase profiling, and the byte and operation model of the port's
kernels; the port of the JAX package's `utils/profiling.py`.

`measure_phases` times each V-cycle phase (smooth, residual, restrict,
prolong, coarse solve, rhs, norm) in isolation on the model's real
per-level arrays, paired with an analytic byte and flop model, and
`profile_step` combines them with the per-step phase counts into a
modelled breakdown of the step beside its measured time.  On a CUDA device
a phase's time is the card's time for `inner` back-to-back calls
(`utils.timing.device_ms`: CUDA events, the calls queued behind a spin
kernel, so the host's cost of issuing them is not counted; the JAX package
amortizes dispatch by a `lax.scan` loop instead); on the CPU it is the host
clock, a host time and no device metric.  `trace_step` records a
torch.profiler trace of real steps.

The kernel model (`smooth_cost`, `open_cost`, `open_smooth_cost`,
`tower_cost`, `probe_cost`, `io_cost`) counts each array a kernel must read or write
once, whatever it reads again from the caches, and the operations its
inputs need; `bound_ms` turns a count into the least time the H100 could
take: the larger of bytes over 3.35 TB/s and operations over the peak rate
of their type.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.mg.cycle import (
    _restrict,
    _smooth_block,
    coarse_solve_dense,
    coarse_solve_gs,
)
from hpcclassmultigridproject_tpu_torch.ops.cuda import backend_route
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    compute_rhs,
    interior_norm,
    prolong_bilinear,
    residual,
    restrict_inject,
)
from hpcclassmultigridproject_tpu_torch.utils.timing import (
    device_ms,
    device_sync,
    profile,
)

# NVIDIA H100 SXM data sheet: HBM3 rate, and the dense peak rates outside
# the tensor cores (float32 67 TFLOP/s, float64 34 TFLOP/s), at 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {4: 67e12, 8: 34e12}

# The reference's flop model: 31 flops/point/sweep for red-black GS; the
# residual and rhs are the same stencil without the division (~10).
FLOPS_PER_POINT = {"smooth": 31.0, "residual": 10.0, "rhs": 10.0,
                   "restrict": 0.0, "prolong": 4.0, "norm": 2.0}
# The delta opening per node: TwoSum and renormalization, two difference
# forms (hi and lo) and the masked combination.
OPEN_FLOPS_PER_POINT = 38.0

# Stored coefficient arrays a smoothing kernel reads, by level form.
_COEF_ARRAYS = {"from_v": 2, "five": 4, "nine": 9}

# P's index maps: the shares of x each reads and writes.
_PROBE_MAPS = {"stride2_rows": (0.5, 0.5), "interleave_rows": (1.0, 2.0),
               "flatten": (1.0, 1.0)}
# P's products: the operands of each, left and right.
_PROBE_PRODUCTS = {"dot_decimate": ("x", "D"),
                   "dot_decimate_rows": ("Dr", "x"),
                   "dot_prolong_rows": ("P", "x")}


def _elems(level) -> int:
    """Padded element count: what moves through device memory."""
    return int(np.prod(level.padded))


def _dof(level) -> int:
    """Interior (true) degrees of freedom of a whole level."""
    return (level.n - 1) ** 2


def _points(level) -> int:
    """Interior nodes the level's arrays hold (a block of a
    row-partitioned level holds some of the interior rows)."""
    rows = level.padded[0]
    first = max(1, level.row_off)
    last = min(level.n - 1, level.row_off + rows - 1)
    return max(0, last - first + 1) * (level.n - 1)


# -- the kernels' byte and operation model ---------------------------------


def smooth_cost(level, itemsize: int, nsweeps: int, *, read_u: bool = True,
                corr: bool = False, want_residual: bool = False,
                res_dec: bool = False) -> tuple[float, float]:
    """(bytes, flops) of one smoothing block (K2, K5, K6, K7): u (unless
    from zero), corr, rhs and the level form's coefficient arrays read, u
    written, and the residual (its even rows alone with `res_dec`)."""
    arrays = (int(read_u) + int(corr) + 1 + _COEF_ARRAYS[level.form]) + 1
    if want_residual:
        arrays += 0.5 if res_dec else 1.0
    pts = _points(level)
    flops = FLOPS_PER_POINT["smooth"] * pts * nsweeps
    if want_residual:
        flops += FLOPS_PER_POINT["residual"] * pts
    return arrays * _elems(level) * itemsize, flops


def open_cost(level, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) of the delta opening (K1): hi, lo, d, v1, v2 read,
    hi', lo', rhs_δ written."""
    return 8 * _elems(level) * itemsize, OPEN_FLOPS_PER_POINT * _points(level)


def open_smooth_cost(level, itemsize: int, nsweeps: int,
                     res_dec: bool) -> tuple[float, float]:
    """(bytes, flops) of the whole-step opening (K8): K1's five inputs
    read; hi', lo', rhs_δ, u1 and the residual written."""
    arrays = 5 + 4 + (0.5 if res_dec else 1.0)
    _, open_flops = open_cost(level, itemsize)
    _, smooth_flops = smooth_cost(level, itemsize, nsweeps, read_u=False,
                                  want_residual=True, res_dec=res_dec)
    return arrays * _elems(level) * itemsize, open_flops + smooth_flops


def tower_cost(levels, s: int, itemsize: int, nsweeps: int,
               ascent: bool) -> tuple[float, float]:
    """(bytes, flops) of the tower over levels[s:-1]: per level, the
    descent (K3) reads rhs, v1, v2 and writes u and the coarser rhs; the
    ascent (K4) reads the coarser solution, u, rhs, v1, v2 and writes u."""
    total_b = total_f = 0.0
    for level, coarse in zip(levels[s:-1], levels[s + 1:]):
        e, ec = _elems(level), _elems(coarse)
        pts = _points(level)
        flops = FLOPS_PER_POINT["smooth"] * pts * nsweeps
        if ascent:
            total_b += (ec + 5 * e) * itemsize
            flops += FLOPS_PER_POINT["prolong"] * pts
        else:
            total_b += (4 * e + ec) * itemsize
            flops += FLOPS_PER_POINT["residual"] * pts
        total_f += flops
    return total_b, total_f


def io_cost(inputs, outputs, flops: float = 0.0) -> tuple[float, float]:
    """(bytes, flops) of a kernel that reads each of `inputs` and writes
    each of `outputs` (tensors, or byte counts) once."""
    nbytes = sum(t if isinstance(t, (int, float)) else
                 t.numel() * t.element_size() for t in (*inputs, *outputs))
    return float(nbytes), float(flops)


def probe_cost(name: str, operands) -> tuple[float, float]:
    """(bytes, flops) of P's probe `name` on `operands` (the arrays of
    `ops.cuda.probe.probe_operands`, numpy or torch): an index map reads
    and writes its share of x once; a product reads both factors, writes
    the product, and does two operations for each product of nonzeros that
    these factors hold."""
    if name in _PROBE_MAPS:
        x = torch.as_tensor(operands["x"])
        read, written = _PROBE_MAPS[name]
        nbytes = x.numel() * x.element_size()
        return io_cost([read * nbytes], [written * nbytes])
    a, b = (torch.as_tensor(operands[k]) for k in _PROBE_PRODUCTS[name])
    products = float(((a != 0).double() @ (b != 0).double()).sum())
    out = a.shape[0] * b.shape[1] * a.element_size()
    return io_cost([a, b], [out], 2.0 * products)


def bound_ms(nbytes: float, flops: float, itemsize: int) -> tuple[float, str]:
    """The least time in ms the H100 could take for (bytes, flops) of
    `itemsize`-byte values, and what bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[itemsize]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- per-phase profile -------------------------------------------------------


def _bytes_model(phase: str, level, itemsize: int, nsweeps: int) -> float:
    """Bytes one invocation of a phase must move (padded elements)."""
    e = _elems(level)
    coef = _COEF_ARRAYS[level.form]
    if phase == "smooth":
        return smooth_cost(level, itemsize, nsweeps)[0]
    if phase == "residual":
        return (2 + coef + 1) * e * itemsize
    if phase == "rhs":
        return (1 + coef + 1) * e * itemsize
    if phase == "restrict":
        return (e + e // 4) * itemsize
    if phase == "prolong":
        return (e // 4 + 2 * e) * itemsize
    if phase == "norm":
        return e * itemsize
    if phase == "coarse":
        m2 = _dof(level)
        return (m2 * m2 + 2 * m2) * itemsize  # dense inverse matvec
    return 0.0


def _flops_model(phase: str, level, nsweeps: int) -> float:
    dof = _dof(level)
    if phase == "smooth":
        return FLOPS_PER_POINT["smooth"] * dof * nsweeps
    if phase == "coarse":
        return 2.0 * dof * dof  # dense matvec against the stored inverse
    return FLOPS_PER_POINT.get(phase, 0.0) * dof


def _phase_counts(cfg, num_levels: int) -> dict[str, dict[int, float]]:
    """How many times each phase runs per *step* (1 rhs + num_cycles cycles).

    In a cycle with shape s (1=V, 2=W) the level-`l` body executes s^(l+1)
    times (the reference's `for sh` loop wraps the whole body).  Each
    non-coarsest body does 2*niter smoothing sweeps, one residual, one
    restrict, one prolong.  Fine-level residual+norm run once before and
    once after the cycles (the fixed-cycle certificate).
    """
    s = cfg.cycle_shape
    cycles = cfg.num_cycles if cfg.cycle_mode == "fixed" else 1
    counts: dict[str, dict[int, float]] = {
        "smooth": {}, "residual": {}, "restrict": {}, "prolong": {},
        "coarse": {}, "rhs": {0: 1.0}, "norm": {0: 2.0},
    }
    for lvl in range(num_levels - 1):
        body = cycles * s ** (lvl + 1)
        counts["smooth"][lvl] = 2.0 * body          # pre+post blocks
        counts["residual"][lvl] = 1.0 * body
        counts["restrict"][lvl] = 1.0 * body
        counts["prolong"][lvl] = 1.0 * body
    counts["coarse"][num_levels - 1] = cycles * float(s ** num_levels)
    counts["residual"][0] = counts["residual"].get(0, 0.0) + 2.0  # certificate
    return counts


def _level_fields(model):
    """Representative (u, rhs) per level in the cycle dtype."""
    u = model.u0.to(model.solver.dtype)
    fields = []
    for lvl, level in enumerate(model.levels):
        if lvl > 0:
            u = restrict_inject(u, level.padded)
        fields.append((u, compute_rhs(level, u)))
    return fields


def _seconds_per_call(fn, inner: int, reps: int, device) -> float:
    """Best of `reps` timings of `inner` back-to-back calls of fn, per call:
    the card's time (`device_ms`) on a CUDA device, the host clock on the
    CPU.  One warm-up call first."""
    if torch.device(device).type == "cuda":
        best = min(device_ms(fn, inner) for _ in range(reps)) / 1e3
    else:
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            best = min(best, (time.perf_counter() - t0) / inner)
    return max(best, 1e-12)


def measure_phases(model, reps: int = 5, inner: int = 32) -> list[dict]:
    """Time each cycle phase on the model's real arrays, `inner` calls back
    to back per timing, best of `reps`.

    Returns one record per (phase, level): best ms per invocation, the
    modelled GB and GFLOP (31 flops/pt/sweep reference model), achieved
    GB/s, GFLOP/s and stencil GDOF/s.
    """
    cfg = model.solver
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    fields = _level_fields(model)
    records = []

    def add(phase, lvl, fn, nsweeps=1):
        level = model.levels[lvl]
        sec = _seconds_per_call(fn, inner, reps, model.device)
        gb = _bytes_model(phase, level, itemsize, nsweeps) / 1e9
        gflop = _flops_model(phase, level, nsweeps) / 1e9
        records.append({
            "phase": phase, "level": lvl, "n": level.n,
            "best_ms": sec * 1e3,
            "gdof_s": _dof(level) * nsweeps / sec / 1e9,
            "model_gb": gb, "achieved_gb_s": gb / sec,
            "model_gflop": gflop, "achieved_gflop_s": gflop / sec,
        })

    last = len(model.levels) - 1
    for lvl, level in enumerate(model.levels):
        u, rhs = fields[lvl]
        if lvl < last:
            add("smooth", lvl,
                lambda l=level, u=u, r=rhs: _smooth_block(cfg, l, u, r,
                                                          False)[0],
                nsweeps=cfg.niter)
            add("residual", lvl, lambda l=level, u=u, r=rhs: residual(l, u, r))
            coarse = model.levels[lvl + 1]
            res = residual(level, u, rhs)
            add("restrict", lvl,
                lambda r=res, c=coarse: _restrict(cfg, r, c))
            u_c = fields[lvl + 1][0]
            add("prolong", lvl,
                lambda uc=u_c, uf=u, p=level.padded:
                    uf + prolong_bilinear(uc, p))
        elif cfg.coarse_mode == "dense" and level.a_inv is not None:
            add("coarse", lvl, lambda l=level, r=rhs: coarse_solve_dense(l, r))
        else:
            add("coarse", lvl,
                lambda l=level, u=u, r=rhs: coarse_solve_gs(l, u, r, cfg))
    u0, rhs0 = fields[0]
    add("rhs", 0, lambda: compute_rhs(model.levels[0], u0))
    add("norm", 0, lambda: interior_norm(rhs0))
    return records


def profile_step(model, reps: int = 5, inner: int = 32) -> dict:
    """Full profile: isolated phase timings and the modelled per-step
    breakdown beside the measured step (a `run_chunk` of `inner` steps,
    per step).

    `modeled_ms` = sum(phase best time x per-step count); its gap to
    `step_ms` (`fusion_gain_ms`) is what the fused kernels and the tower
    buy over the isolated phases.
    """
    cfg = model.solver
    with backend_route(cfg.backend):
        phases = measure_phases(model, reps=reps, inner=inner)
    counts = _phase_counts(cfg, len(model.levels))
    by_phase: dict[str, float] = {}
    modeled = 0.0
    for rec in phases:
        cnt = counts.get(rec["phase"], {}).get(rec["level"], 0.0)
        contrib = rec["best_ms"] * cnt
        rec["per_step_count"] = cnt
        rec["per_step_ms"] = contrib
        by_phase[rec["phase"]] = by_phase.get(rec["phase"], 0.0) + contrib
        modeled += contrib

    u = model.u0
    step_ms = _seconds_per_call(lambda: model.run_chunk(u, inner)[0], 1,
                                reps, model.device) / inner * 1e3
    total = sum(by_phase.values()) or 1.0
    return {
        "step_ms": step_ms,
        "modeled_ms": modeled,
        "fusion_gain_ms": modeled - step_ms,
        "phase_share": {k: v / total for k, v in sorted(
            by_phase.items(), key=lambda kv: -kv[1])},
        "phase_ms": by_phase,
        "phases": phases,
    }


def trace_step(model, logdir: str, nsteps: int = 3) -> str:
    """Record a torch.profiler trace of `nsteps` real steps into
    `logdir/trace.json` (Chrome trace format); returns logdir."""
    u, _ = model.step(model.u0)  # builds the kernels outside the trace
    device_sync(u)
    with profile(logdir):
        for _ in range(nsteps):
            u, _ = model.step(u)
        device_sync(u)
    return logdir
