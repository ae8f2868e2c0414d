from .energies import (
    EUC_CONE_K,
    HYP_CONE_K,
    euc_cone_energy,
    hyp_cone_energy,
    inner_radius,
    order_energy,
)
from .pairwise import (
    pairwise_energy,
    pairwise_energy_sharded,
    pairwise_euc_cone_energy,
    pairwise_hyp_cone_energy,
    pairwise_order_energy,
)
from .poincare import (
    arctanh,
    exp_map_x,
    exp_map_zero_shifted,
    lambda_x,
    mobius_add,
    poincare_distance,
    project_annulus,
)

ENERGY_FNS = {
    "order": order_energy,
    "euc_cone": euc_cone_energy,
    "hyp_cone": hyp_cone_energy,
}

__all__ = [
    "EUC_CONE_K",
    "HYP_CONE_K",
    "ENERGY_FNS",
    "arctanh",
    "euc_cone_energy",
    "exp_map_x",
    "exp_map_zero_shifted",
    "hyp_cone_energy",
    "inner_radius",
    "lambda_x",
    "mobius_add",
    "order_energy",
    "pairwise_energy",
    "pairwise_energy_sharded",
    "pairwise_euc_cone_energy",
    "pairwise_hyp_cone_energy",
    "pairwise_order_energy",
    "poincare_distance",
    "project_annulus",
]
