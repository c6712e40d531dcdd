"""peak_reserved_gib: torch.cuda.max_memory_reserved() over set-up and the
window, the captured program's pool included, in GiB (None off the
card)."""


def read(ctx):
    if ctx.peak_reserved is None:
        return None
    return ctx.peak_reserved / 2**30
