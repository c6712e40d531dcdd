"""cycles_per_step: the mean of the runs' stats["cycles"], cycles a step,
over the window's runs."""


def read(ctx):
    cycles = ctx.window.cycles
    return float(sum(float(c.sum()) for c in cycles)) / (
        len(cycles) * ctx.steps)
