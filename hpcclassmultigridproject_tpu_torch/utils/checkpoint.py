"""Checkpoint and resume, the port's copy of the JAX package's
`utils/checkpoint.py`.

Snapshots are (step, u) pairs in .npz beside a JSON manifest of the problem
configuration, in the JAX package's format: a directory written by either
package resumes in the other (`dataclasses.asdict` of the two
`ProblemConfig`s is the same).  Atomic renames keep a crash from leaving a
torn snapshot.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.utils.io import as_numpy


class CheckpointManager:
    """Directory of step-stamped snapshots with atomic writes.

    >>> mgr = CheckpointManager(dir, problem_cfg)
    >>> mgr.save(step, u)
    >>> step, u = mgr.load_latest()
    """

    def __init__(self, directory, problem=None, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.manifest_path = self.dir / "manifest.json"
        if problem is not None:
            manifest = {"problem": dataclasses.asdict(problem)}
            if self.manifest_path.exists():
                old = json.loads(self.manifest_path.read_text())
                if old != manifest:
                    raise ValueError(
                        f"checkpoint dir {self.dir} belongs to a different "
                        f"problem config: {old} != {manifest}")
            else:
                self.manifest_path.write_text(json.dumps(manifest))

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}.npz"

    def save(self, step: int, u) -> None:
        tmp = self.dir / f".tmp_step_{step:08d}.npz"
        np.savez(tmp, step=np.int64(step), u=as_numpy(u))
        os.replace(tmp, self._path(step))
        self._prune()

    def steps(self) -> list[int]:
        return sorted(
            int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.npz"))

    def load(self, step: int):
        with np.load(self._path(step)) as z:
            return int(z["step"]), z["u"]

    def load_latest(self):
        steps = self.steps()
        if not steps:
            return None
        return self.load(steps[-1])

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            self._path(s).unlink()


def stitch_stats(chunks: list[dict]) -> dict | None:
    """One run's per-step stats from those of its consecutive chunks
    (`run_chunk`'s), or None without chunks.  A per-step array joins along
    the step axis.  A scalar is the last chunk's: the delta form's
    `final_rel_residual_hi` certifies a chunk's last step, so the last
    chunk's certifies the run's.  Under `certify_every` the delta form
    certifies every k-th step of each chunk, counted from the chunk's
    start: with chunks a multiple of k long, the steps of an unchunked
    run."""
    if not chunks:
        return None
    return {k: torch.cat([c[k] for c in chunks]) if v.ndim else v
            for k, v in chunks[-1].items()}


def run_with_checkpoints(model, mgr: CheckpointManager, every: int = 10,
                         on_chunk=None):
    """Drive a model in `every`-step chunks, checkpointing the logical field
    after each chunk and resuming from the latest snapshot if one exists.
    Returns (uT, steps done).  Each chunk ends in a copy to the host;
    `on_chunk`, if given, is called with each chunk's stats (for
    `stitch_stats`)."""
    total = model.problem.num_steps
    latest = mgr.load_latest()
    if latest is None:
        step, u = 0, model.u0
    else:
        step, u_np = latest
        u = model.pad(torch.as_tensor(u_np, dtype=model.u0.dtype,
                                      device=model.u0.device))
    while step < total:
        chunk = min(every, total - step)
        u, stats = model.run_chunk(u, chunk)
        if on_chunk is not None:
            on_chunk(stats)
        step += chunk
        mgr.save(step, model.crop(u))
    return model.crop(u), step
