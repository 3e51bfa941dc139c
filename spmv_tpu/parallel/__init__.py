"""Multi-device execution layer (mesh row-partitioned SpMV)."""

from .mesh import (DistSpmvPlan, build_dist_plan, dist_spmv,
                   DistDiaPlan, build_dist_dia_plan, dist_dia_spmv,
                   DistAutoPlan, build_dist_auto, dist_auto_spmv,
                   make_mesh_1d)

__all__ = ["DistSpmvPlan", "build_dist_plan", "dist_spmv",
           "DistDiaPlan", "build_dist_dia_plan", "dist_dia_spmv",
           "DistAutoPlan", "build_dist_auto", "dist_auto_spmv",
           "make_mesh_1d"]
