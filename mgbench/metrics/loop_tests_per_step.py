"""loop_tests_per_step: the loop tests (ops.cuda.LAUNCHES["while_set"],
which each replay adds from its WHILE nodes' trip counters) the traced
runs made, over their steps; None where the runs made none."""


def read(ctx):
    t = ctx.traced
    if t is None or not t.loop_tests:
        return None
    return t.loop_tests / (t.runs * ctx.steps)
