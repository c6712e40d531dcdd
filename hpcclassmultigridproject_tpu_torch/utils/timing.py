"""Timing helpers, the port of the JAX package's `utils/timing.py`.

PyTorch returns before the card finishes, so a host clock measures a CUDA
computation only after `torch.cuda.synchronize()`; `device_sync` is that
one choke point (nothing to wait for on the CPU).  `device_ms` measures the
card's own time for a call, without the host's cost of issuing it.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


def device_sync(x) -> None:
    """Block until the card has finished the work queued before this call,
    when x (or its first element, for a tuple or list) is a CUDA tensor;
    nothing on the CPU."""
    leaf = x[0] if isinstance(x, (tuple, list)) else x
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


# Cycles per second the spin kernel of `device_ms` is sized with: at least
# the H100's top SM clock (1.98 GHz), so the spin lasts as long as asked.
_SPIN_HZ = 2.0e9


def device_ms(fn, reps: int) -> float:
    """The card's time per call of `fn` (CUDA work), in ms: CUDA events
    around `reps` calls queued behind a spin kernel (`torch.cuda._sleep`)
    four times as long as the host took to issue them, so the events see
    the calls' kernels back to back and not the host's cost between them.
    One warm-up call first; a call that synchronizes inside still counts
    its whole wall."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * issue_s * _SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Timer:
    """Wall-clock timer with device synchronization.

    >>> with Timer() as t:
    ...     out = model.run()
    ...     t.sync(out[0])
    >>> t.seconds
    """

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.seconds = None
        return self

    def sync(self, x) -> None:
        device_sync(x)

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


def time_run(fn, *args, reps: int = 3, warmup: int = 1) -> dict:
    """Best-of-`reps` wall time of `fn(*args)`, each call synchronized,
    after `warmup` untimed calls (the first builds the kernels and, for a
    model's entry point on the card, captures its compiled program, as
    the JAX package's first call compiles)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        device_sync(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        device_sync(out)
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times),
            "times": times, "out": out}


@contextlib.contextmanager
def profile(logdir: str):
    """torch.profiler over the block (CPU, and CUDA where available); on
    exit writes a Chrome trace to `logdir/trace.json` (chrome://tracing,
    Perfetto)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
