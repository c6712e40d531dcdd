from hpcclassmultigridproject_tpu_torch.mg.cycle import (
    fmg_solve,
    mg_cycle,
    mg_solve,
    mg_solve_fixed,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    Level,
    build_fine_level,
    build_hierarchy,
)
from hpcclassmultigridproject_tpu_torch.mg.refine import refined_solve
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

__all__ = [
    "Level", "build_fine_level", "build_hierarchy",
    "fmg_solve", "mg_cycle", "mg_solve", "mg_solve_fixed", "refined_solve",
    "timestepper",
]
