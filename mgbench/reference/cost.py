"""The yardstick's byte and operation model, and the least time of a run.

The first part is a frozen copy of the port's kernel cost model,
`hpcclassmultigridproject_tpu_torch/utils/profiling.py` as of its
`smooth_cost`, `open_cost`, `tower_cost`, `_bytes_model`, `_flops_model`,
`_phase_counts` and `bound_ms`: each array a pass must read or write is
counted once, whatever it reads again from the caches, and the operations
its inputs need.  It is kept here so that a change to the program cannot
move the yardstick; mgbench/tests checks the copy against the program's
model at three shapes.  It takes any object with the attributes `n`,
`padded` (rows, columns), `form` ("from_v", "five" or "nine") and
`row_off`.

The second part (`run_work`) walks one Crank–Nicolson run of a solver
configuration, pass by pass, and sums the bytes and operations of its
algorithm at the logical grid of each level ((n+1)² nodes, not the
program's padded layout): the least work the algorithm needs, whatever
implements it.  `least_seconds` turns that into the least time the chip
could take, against the data sheet's peaks.
"""

from __future__ import annotations

import dataclasses
import math

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


def _elems(level) -> int:
    """Element count of the level's arrays: what moves through memory."""
    return int(math.prod(level.padded))


def _dof(level) -> int:
    """Interior (true) degrees of freedom of a whole level."""
    return (level.n - 1) ** 2


def _points(level) -> int:
    """Interior nodes the level's arrays hold."""
    rows = level.padded[0]
    first = max(1, level.row_off)
    last = min(level.n - 1, level.row_off + rows - 1)
    return max(0, last - first + 1) * (level.n - 1)


def smooth_cost(level, itemsize: int, nsweeps: int, *, read_u: bool = True,
                corr: bool = False, want_residual: bool = False,
                res_dec: bool = False) -> tuple[float, float]:
    """(bytes, flops) of one smoothing block: u (unless from zero), corr,
    rhs and the level form's coefficient arrays read, u written, and the
    residual (its even rows alone with `res_dec`)."""
    arrays = (int(read_u) + int(corr) + 1 + _COEF_ARRAYS[level.form]) + 1
    if want_residual:
        arrays += 0.5 if res_dec else 1.0
    pts = _points(level)
    flops = FLOPS_PER_POINT["smooth"] * pts * nsweeps
    if want_residual:
        flops += FLOPS_PER_POINT["residual"] * pts
    return arrays * _elems(level) * itemsize, flops


def open_cost(level, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) of the delta opening: hi, lo, d, v1, v2 read, hi',
    lo', rhs_δ written."""
    return 8 * _elems(level) * itemsize, OPEN_FLOPS_PER_POINT * _points(level)


def tower_cost(levels, s: int, itemsize: int, nsweeps: int,
               ascent: bool) -> tuple[float, float]:
    """(bytes, flops) of a zero-iterate V-cycle's half over levels[s:-1]:
    per level, the descent reads rhs, v1, v2 and writes u and the coarser
    rhs; the ascent reads the coarser solution, u, rhs, v1, v2 and writes
    u."""
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


def bound_ms(nbytes: float, flops: float, itemsize: int) -> tuple[float, str]:
    """The least time in ms the H100 could take for (bytes, flops) of
    `itemsize`-byte values, and what bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[itemsize]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bytes_model(phase: str, level, itemsize: int, nsweeps: int) -> float:
    """Bytes one invocation of a phase must move."""
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
    """How many times each phase runs per step (1 rhs + num_cycles cycles)
    of a cycle of shape s (1=V, 2=W): the level-`l` body s^(l+1) times,
    each non-coarsest body 2 smoothing blocks, one residual, one restrict,
    one prolong; fine-level residual and norm once before and once after
    the cycles."""
    s = cfg.cycle_shape
    cycles = cfg.num_cycles if cfg.cycle_mode == "fixed" else 1
    counts: dict[str, dict[int, float]] = {
        "smooth": {}, "residual": {}, "restrict": {}, "prolong": {},
        "coarse": {}, "rhs": {0: 1.0}, "norm": {0: 2.0},
    }
    for lvl in range(num_levels - 1):
        body = cycles * s ** (lvl + 1)
        counts["smooth"][lvl] = 2.0 * body
        counts["residual"][lvl] = 1.0 * body
        counts["restrict"][lvl] = 1.0 * body
        counts["prolong"][lvl] = 1.0 * body
    counts["coarse"][num_levels - 1] = cycles * float(s ** num_levels)
    counts["residual"][0] = counts["residual"].get(0, 0.0) + 2.0
    return counts


# -- one run's work -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """A level's logical grid: (n+1)² nodes, velocities as its operator
    (the rediscretized CN operator reads v1 and v2)."""

    n: int
    form: str = "from_v"
    row_off: int = 0

    @property
    def padded(self) -> tuple[int, int]:
        return self.n + 1, self.n + 1


class Work:
    """Bytes, and operations by value size, summed pass by pass."""

    def __init__(self):
        self.nbytes = 0.0
        self.flops = {4: 0.0, 8: 0.0}

    def add(self, cost: tuple[float, float], itemsize: int,
            times: float = 1.0) -> None:
        self.nbytes += cost[0] * times
        self.flops[itemsize] += cost[1] * times

    def least_seconds(self) -> float:
        """The larger of the bytes at the HBM rate and the operations at
        their peak rates."""
        t_ops = sum(f / PEAK_FLOP_PER_S[k] for k, f in self.flops.items())
        return max(self.nbytes / HBM_BYTES_PER_S, t_ops)


def _norm_cost(level, itemsize: int) -> tuple[float, float]:
    return (_bytes_model("norm", level, itemsize, 1),
            _flops_model("norm", level, 1))


def _restrict_cost(level, coarse, itemsize: int,
                   res_dec: bool) -> tuple[float, float]:
    """Injection: the residual read (its even rows alone where the
    smoothing block emitted only those) and the coarse rhs written."""
    read = _elems(level) * (0.5 if res_dec else 1.0)
    return (read + _elems(coarse)) * itemsize, 0.0


def _prolong_cost(level, coarse, itemsize: int) -> tuple[float, float]:
    """Bilinear prolongation: the coarse correction read, the fine
    correction written."""
    return ((_elems(coarse) + _elems(level)) * itemsize,
            FLOPS_PER_POINT["prolong"] * _points(level))


def _coarse_cost(level, itemsize: int, mode: str,
                 nsweeps: int) -> tuple[float, float]:
    """The coarsest solve: the dense inverse's matvec, or (Gauss–Seidel to
    a tolerance) at least one block of sweeps and its residual norm."""
    if mode == "dense":
        return (_bytes_model("coarse", level, itemsize, 1),
                _flops_model("coarse", level, 1))
    b, f = smooth_cost(level, itemsize, nsweeps, want_residual=True)
    return b + _elems(level) * itemsize, f


def _vcycle(work: Work, grids, solver: dict, itemsize: int, lvl: int,
            from_zero: bool, final_residual: bool) -> None:
    """One V-cycle from level `lvl` down: pre-smooth emitting the residual,
    restrict, the correction solve below, prolong, post-smooth folding in
    the correction."""
    level = grids[lvl]
    nsweeps = solver.get("niter", 3)
    if lvl == len(grids) - 1:
        work.add(_coarse_cost(level, itemsize, solver["coarse_mode"],
                              nsweeps), itemsize)
        return
    coarse = grids[lvl + 1]
    res_dec = solver.get("restriction", "inject") == "inject"
    work.add(smooth_cost(level, itemsize, nsweeps, read_u=not from_zero,
                         want_residual=True, res_dec=res_dec), itemsize)
    work.add(_restrict_cost(level, coarse, itemsize, res_dec), itemsize)
    _vcycle(work, grids, solver, itemsize, lvl + 1, True, False)
    work.add(_prolong_cost(level, coarse, itemsize), itemsize)
    work.add(smooth_cost(level, itemsize, nsweeps, read_u=True, corr=True,
                         want_residual=final_residual), itemsize)


def _certificate(work: Work, fine, lo_size: int, hi_size: int) -> None:
    """A high-dtype certificate of a delta step: hi, lo and δ read in the
    working dtype, v1 and v2 in the high one; the delta rhs, A·δ and two
    norms."""
    b = 3 * _elems(fine) * lo_size + 2 * _elems(fine) * hi_size
    f = (OPEN_FLOPS_PER_POINT + FLOPS_PER_POINT["residual"]
         + 2 * FLOPS_PER_POINT["norm"]) * _points(fine)
    work.add((b, f), hi_size)


def num_levels(n: int, solver: dict) -> int:
    """The upstream's depth: log2(n) − 4 levels, the coarsest n = 32."""
    return solver.get("num_levels") or max(int(math.log2(n)) - 4, 1)


def run_work(n: int, num_steps: int, solver: dict,
             cycles_per_step) -> Work:
    """The work of one run of `num_steps` CN steps at grid n under the
    solver settings `solver` (a traffic file's "solver"), with
    `cycles_per_step[t]` cycles at step t (the program's stats)."""
    grids = [Grid(n >> lvl) for lvl in range(num_levels(n, solver))]
    fine = grids[0]
    work = Work()
    if solver.get("delta_form"):
        lo, hi = 4, 8
        work.add((2 * _elems(fine) * hi, 0.0), hi)      # u0 read, uT written
        every = solver.get("certify_every", 0)
        for t in range(num_steps):
            work.add(open_cost(fine, lo), lo)
            cycles = int(cycles_per_step[t])
            for k in range(cycles):
                _vcycle(work, grids, solver, lo, 0, k == 0, k == cycles - 1)
            work.add(_norm_cost(fine, lo), lo, 2)
            if every and t % every == every - 1:
                _certificate(work, fine, lo, hi)
        _certificate(work, fine, lo, hi)                 # the epilogue
        return work
    size = 8 if solver.get("dtype") == "float64" else 4
    work.add((2 * _elems(fine) * size, 0.0), size)
    for t in range(num_steps):
        work.add((_bytes_model("rhs", fine, size, 1),
                  _flops_model("rhs", fine, 1)), size)
        for k in range(int(cycles_per_step[t]) + 1):
            # the residual norm before the cycles and after each
            work.add((_bytes_model("residual", fine, size, 1),
                      _flops_model("residual", fine, 1)), size)
            work.add(_norm_cost(fine, size), size)
            if k:
                _vcycle(work, grids, solver, size, 0, False, False)
    return work
