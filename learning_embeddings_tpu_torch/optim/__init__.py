from .rsgd import (
    RiemannianAdam,
    RiemannianSGD,
    project_annulus_,
    scale_by_conformal_factor_,
)

__all__ = ["RiemannianAdam", "RiemannianSGD", "project_annulus_",
           "scale_by_conformal_factor_"]
