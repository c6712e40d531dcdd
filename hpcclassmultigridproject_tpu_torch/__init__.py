"""hpcclassmultigridproject_tpu_torch — the PyTorch/CUDA port of
hpcclassmultigridproject_tpu, for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package mirrors its
module names and imports torch and numpy, never jax.  It runs the
single-device solver: Crank–Nicolson advection–diffusion with the
adaptive, fixed, FMG, refined and delta steppers (the delta stepper
optionally opening each step with the whole-step kernel), V- and W-cycles
of red–black GS, weighted-Jacobi or Chebyshev smoothing with injection or
full weighting, dense or GS coarse solves, rediscretized or Galerkin
coarse operators, and the Poisson family; the same runs partitioned over
`torch.distributed` ranks by rows or in 2-D blocks
(`parallel.distributed_run`); the logical-shape operations (`ops`), the
native C++ oracle (`native`) and the CLI.  Its kernels are hand-written
CUDA C++ in `csrc/`, built with nvcc at first use (`ops/cuda/_build.py`);
on CPU tensors, or in a solve of `backend="jnp"`, each kernel's plain
PyTorch version runs instead.  Entry points run on the card unless asked
for the CPU (`device="cpu"`).

Layer map:
  cli.py      the command-line interface (`python -m ....cli`)
  utils/      timing, field I/O, checkpoints, per-phase profile and the
              kernels' byte model
  core/       padded layout, problem fields
  ops/        the logical-shape operations (stencil, smoothers,
              transfer), plain level operations (padded.py) and the
              kernels (cuda/), with the Hopper feature probe
              (cuda/probe.py)
  mg/         levels, cycles and solvers, refined and delta
              steppers, timestepper
  sparse/     Galerkin R·A·P coarse operators
  models/     AdvectionDiffusion, Poisson
  parallel/   the partitioned run, by rows or in 2-D blocks: ranks,
              collectives, deep-halo smoothing (K7), halo sweeps
              (halo.py), block forms of the level ops
  native/     the serial float64 C++ oracle (mgref.cpp), built with g++
  interop.py  the JAX package's level fields into the port's levels
"""

from hpcclassmultigridproject_tpu_torch.config import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.cycle import mg_cycle, mg_solve
from hpcclassmultigridproject_tpu_torch.mg.levels import Level, build_hierarchy
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

__all__ = [
    "ProblemConfig",
    "SolverConfig",
    "Level",
    "build_hierarchy",
    "mg_cycle",
    "mg_solve",
    "timestepper",
]
