"""dof_rate: interior points (n−1)² × CN steps of the certified runs
completed in the window, over the window's seconds, in G dof-steps/s."""


def read(ctx):
    done = ctx.window.passed.count(True)
    return done * ctx.dof_steps / ctx.window.seconds / 1e9
