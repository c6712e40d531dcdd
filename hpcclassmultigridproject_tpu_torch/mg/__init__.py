from hpcclassmultigridproject_tpu_torch.mg.cycle import mg_cycle
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    Level,
    build_fine_level,
    build_hierarchy,
)
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

__all__ = ["Level", "build_fine_level", "build_hierarchy", "mg_cycle",
           "timestepper"]
