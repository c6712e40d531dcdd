"""capture_s: the seconds the run's program took to warm up, capture and
instantiate (utils/graphs.py's Program.seconds); None where no program
was captured."""


def read(ctx):
    return None if ctx.program is None else ctx.program.seconds
