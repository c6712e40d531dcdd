from hpcclassmultigridproject_tpu_torch.models.advection_diffusion import (
    AdvectionDiffusion,
)
from hpcclassmultigridproject_tpu_torch.models.poisson import (
    Poisson,
    build_poisson_hierarchy,
    poisson_level,
)

__all__ = [
    "AdvectionDiffusion",
    "Poisson",
    "build_poisson_hierarchy",
    "poisson_level",
]
