"""setup_s: process start to the first timed run: imports, the kernel
library's build or load, the model's build, the input bank, the warm
runs and the capture, in s."""


def read(ctx):
    return ctx.setup_s
