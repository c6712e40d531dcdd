from hpcclassmultigridproject_tpu_torch.models.advection_diffusion import (
    AdvectionDiffusion,
)

__all__ = ["AdvectionDiffusion"]
