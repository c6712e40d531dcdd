"""The reduction of a torch.profiler trace to what the metric readers read.

`collect` keeps, from the profiler's Kineto events, the device's
operations (kernels, copies, sets) and the host's annotated ranges, as
plain (name, start_ns, end_ns) tuples in memory; nothing is written to
disk.  The functions below work on those tuples alone, so they are tested
on made-up intervals.
"""

from __future__ import annotations

import dataclasses
import re

# the host ranges the harness marks around each traced run
RUN_RANGE = "mgbench.run"
READ_RANGE = "mgbench.certificates"
# the profiler's names of the device's copies and sets ("Memcpy DtoD
# (Device -> Device)", "Memset (Device)")
COPY = re.compile(r"Memcpy|Memset|memcpy|memset")


@dataclasses.dataclass
class Trace:
    """What one traced segment of runs left: the device's operations by
    kind, the host's ranges, and the segment's span (the first run's start
    to the last read's end), all in ns of the profiler's clock."""

    kernels: list
    copies: list
    host: list
    span: tuple

    @property
    def device_ops(self) -> list:
        return self.kernels + self.copies


def collect(prof) -> Trace:
    """The Trace of a finished `torch.profiler.profile`."""
    kernels, copies, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.end_ns())
        if str(e.device_type()).endswith("CUDA"):
            if item[0] in (RUN_RANGE, READ_RANGE):
                continue    # the host's ranges drawn on the device's track
            (copies if COPY.match(item[0]) else kernels).append(item)
        else:
            host.append(item)
    runs = [h for h in host if h[0] in (RUN_RANGE, READ_RANGE)]
    span = ((min(h[1] for h in runs), max(h[2] for h in runs)) if runs
            else (0, 0))
    return Trace(kernels, copies, host, span)


def clip(intervals, span) -> list:
    """The intervals cut to the span, empty ones dropped."""
    lo, hi = span
    out = []
    for name, a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((name, a, b))
    return out


def union_ns(intervals) -> int:
    """The length of the union of the (name, start, end) intervals."""
    total, reach = 0, None
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def idle_gaps(intervals, span) -> list:
    """The (start, end) stretches of the span that no interval covers."""
    gaps, reach = [], span[0]
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if span[1] > reach:
        gaps.append((reach, span[1]))
    return gaps


def host_at(host, t: int) -> str:
    """The innermost host range that holds the time t, or "harness loop"
    where none does (the benchmark's own Python between two runs)."""
    holding = [h for h in host if h[1] <= t <= h[2]]
    if not holding:
        return "harness loop"
    return min(holding, key=lambda h: h[2] - h[1])[0]


def layer_of(name: str, patterns: list) -> str:
    """The layer of a device operation: the first of `patterns`
    ([regex, layer] pairs) that its name matches, else "other"."""
    for regex, layer in patterns:
        if re.search(regex, name):
            return layer
    return "other"


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its template arguments, cut to `limit`."""
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:limit]


def breakdown(trace: Trace, patterns: list, top: int = 10) -> dict:
    """The device operations that took the most time, each named after its
    layer, and the longest idle gaps, each named after what the host was
    doing in the middle of it; seconds."""
    ops = clip(trace.device_ops, trace.span)
    by_op: dict = {}
    for name, a, b in ops:
        key = f"{layer_of(name, patterns)}: {short(name)}"
        by_op[key] = by_op.get(key, 0) + (b - a)
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(ops, trace.span), key=lambda g: g[0] - g[1])
    idle = [[host_at(trace.host, (a + b) // 2), (b - a) / 1e9]
            for a, b in gaps[:top]]
    return {"device_ops": [[k, v / 1e9] for k, v in device_ops],
            "idle_gaps": idle}


def layer_seconds(trace: Trace, patterns: list, layer: str) -> float:
    """Seconds of device operations in the span whose layer is `layer`."""
    return sum(b - a for name, a, b in clip(trace.device_ops, trace.span)
               if layer_of(name, patterns) == layer) / 1e9
