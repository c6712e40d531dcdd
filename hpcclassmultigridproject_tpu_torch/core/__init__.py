from hpcclassmultigridproject_tpu_torch.core.problem import (
    gaussian_u0,
    rotating_velocity,
)

__all__ = ["gaussian_u0", "rotating_velocity"]
