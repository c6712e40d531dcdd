"""roofline_pct: the least time the chip could take for the traced runs'
algorithmic work (reference/cost.py at the cell's grid and solver, with
the cycles each step ran, against the H100 SXM data sheet's peaks) over
the device's busy time in those runs, in %; None without a device
trace."""

from mgbench import trace as tracing


def read(ctx):
    t = ctx.traced
    if t is None or not t.trace.kernels:
        return None
    busy = tracing.union_ns(tracing.clip(t.trace.device_ops,
                                         t.trace.span)) / 1e9
    least = sum(
        ctx.cost.run_work(ctx.n, ctx.steps, ctx.cell.traffic["solver"],
                          cycles.tolist()).least_seconds()
        for cycles in t.cycles)
    return 100.0 * least / busy
