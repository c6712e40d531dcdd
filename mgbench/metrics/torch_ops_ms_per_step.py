"""torch_ops_ms_per_step: the profiler's device time of the kernels whose
names match PyTorch's or cuBLAS's (the "torch ops" patterns of
kernel_layers.json) in the traced runs, over their steps, in ms; None
without a device trace."""

from mgbench import trace as tracing


def read(ctx):
    t = ctx.traced
    if t is None or not t.trace.kernels:
        return None
    s = tracing.layer_seconds(t.trace, ctx.layers, "torch ops")
    return 1e3 * s / (t.runs * ctx.steps)
