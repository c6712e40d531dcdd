"""hpcclassmultigridproject_tpu_torch — the PyTorch/CUDA port of
hpcclassmultigridproject_tpu, for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package mirrors its
module names and imports torch and numpy, never jax.  It runs one slice
so far: delta-form Crank–Nicolson stepping with one fixed V-cycle per step
(red–black GS, injection, bilinear prolongation, dense coarse solve) and
f64 certificates.  Its four kernels are hand-written CUDA C++ in `csrc/`,
built with nvcc at first use (`ops/cuda/_build.py`); on CPU tensors each
kernel's plain PyTorch version runs instead.

Layer map:
  core/       padded layout, problem fields
  ops/        plain level operations (padded.py) and the kernels (cuda/)
  mg/         levels, V-cycle, delta stepper, timestepper
  models/     AdvectionDiffusion
  interop.py  the JAX package's level fields into the port's levels
"""

from hpcclassmultigridproject_tpu_torch.config import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.cycle import mg_cycle
from hpcclassmultigridproject_tpu_torch.mg.levels import Level, build_hierarchy
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

__all__ = [
    "ProblemConfig",
    "SolverConfig",
    "Level",
    "build_hierarchy",
    "mg_cycle",
    "timestepper",
]
