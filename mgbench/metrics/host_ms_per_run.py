"""host_ms_per_run: the mean over the traced runs of a run's wall minus
the device time between the CUDA events recorded around the program's
call, in ms: what the host adds to a run (None without a card)."""


def read(ctx):
    t = ctx.traced
    if t is None or not t.device_ms:
        return None
    gaps = [1e3 * w - d for w, d in zip(t.walls, t.device_ms)]
    return sum(gaps) / len(gaps)
