"""Finite-element SPDE models: triangle, surface and interval meshes, P1
assembly, the Matérn and barrier SPDEs, point observation models and
spatiotemporal (advection-diffusion and Kronecker) GMRFs."""

from .barrier import BarrierModel
from .discretization import FEMDiscretization, assemble_coo
from .mesh import (
    IntervalMesh,
    TriangleMesh,
    auto_mesh_size,
    create_inflated_rectangle,
    generate_mesh,
    icosphere,
    interval_mesh,
)
from .obs_models import PointDerivativeObsModel, PointEvaluationObsModel, PointSecondDerivativeObsModel
from .spatiotemporal import (
    AdvectionDiffusionSPDE,
    SpatiotemporalGMRF,
    kronecker_product_spatiotemporal_model,
    product_matern,
    sp_block_tridiag,
    spatial_to_spatiotemporal,
)
from .spde import MaternModel, MaternSPDE, range_to_kappa, smoothness_to_nu

__all__ = [
    "TriangleMesh",
    "IntervalMesh",
    "generate_mesh",
    "create_inflated_rectangle",
    "interval_mesh",
    "icosphere",
    "auto_mesh_size",
    "FEMDiscretization",
    "PointEvaluationObsModel",
    "PointDerivativeObsModel",
    "PointSecondDerivativeObsModel",
    "assemble_coo",
    "MaternSPDE",
    "MaternModel",
    "BarrierModel",
    "range_to_kappa",
    "smoothness_to_nu",
    "SpatiotemporalGMRF",
    "AdvectionDiffusionSPDE",
    "kronecker_product_spatiotemporal_model",
    "product_matern",
    "spatial_to_spatiotemporal",
    "sp_block_tridiag",
]
