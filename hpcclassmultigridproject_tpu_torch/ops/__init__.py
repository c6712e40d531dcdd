"""Level operations: the logical-shape oracle operations on (n+1)² fields
(`stencil`, `smoothers`, `transfer`, the JAX package's `ops` API), the
padded-layout plain PyTorch operations (`padded`), and the hand-written
CUDA kernels with their plain versions (`cuda`)."""

from hpcclassmultigridproject_tpu_torch.ops import padded
from hpcclassmultigridproject_tpu_torch.ops.smoothers import (
    checkerboard,
    rb_gauss_seidel,
    weighted_jacobi,
)
from hpcclassmultigridproject_tpu_torch.ops.stencil import (
    apply_A,
    apply_B,
    compute_rhs,
    interior_norm,
    neighbor_sum,
    residual,
)
from hpcclassmultigridproject_tpu_torch.ops.transfer import (
    prolong_bilinear,
    restrict_full_weighting,
    restrict_inject,
)

__all__ = [
    "padded",
    "neighbor_sum",
    "apply_A",
    "apply_B",
    "compute_rhs",
    "residual",
    "interior_norm",
    "checkerboard",
    "rb_gauss_seidel",
    "weighted_jacobi",
    "restrict_inject",
    "restrict_full_weighting",
    "prolong_bilinear",
]
