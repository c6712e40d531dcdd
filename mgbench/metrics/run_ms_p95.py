"""run_ms_p95: the 95th percentile of the wall of every run in the window,
certified or not (nearest rank: an observed run), in ms."""

import math


def read(ctx):
    walls = sorted(ctx.window.walls)
    rank = math.ceil(0.95 * len(walls))
    return 1e3 * walls[rank - 1]
