"""Utilities: field I/O, timing, checkpointing and per-phase profiling, the
port of the JAX package's `utils/`."""

from hpcclassmultigridproject_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    run_with_checkpoints,
)
from hpcclassmultigridproject_tpu_torch.utils.io import (
    field_difference_norm,
    load_field,
    load_field_txt,
    save_field,
    save_field_txt,
)
from hpcclassmultigridproject_tpu_torch.utils.timing import (
    Timer,
    device_sync,
    profile,
    time_run,
)

__all__ = [
    "CheckpointManager",
    "run_with_checkpoints",
    "field_difference_norm",
    "load_field",
    "load_field_txt",
    "save_field",
    "save_field_txt",
    "Timer",
    "device_sync",
    "profile",
    "time_run",
]
