"""model_build_s: host clock around the model's construction
(AdvectionDiffusion(...), synchronized), in s."""


def read(ctx):
    return ctx.build_s
