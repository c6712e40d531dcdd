"""device_idle_pct: 1 − (union of the device's kernel and copy intervals)
/ (span of the traced runs), from torch.profiler, in %; None without a
device trace."""

from mgbench import trace as tracing


def read(ctx):
    t = ctx.traced
    if t is None or not t.trace.kernels:
        return None
    span = t.trace.span[1] - t.trace.span[0]
    busy = tracing.union_ns(tracing.clip(t.trace.device_ops, t.trace.span))
    return 100.0 * (1.0 - busy / span)
