from .ar import AR1Model, ARModel
from .base import LatentModel, process_constraint, stack_constraints
from .besag import BesagModel, BYM2Model
from .car import CARModel, generate_car_model
from .combined import CombinedModel
from .grid import grid_matern2_precision
from .iid import FixedEffectsModel, IIDModel
from .nongaussian import AutoDiffLatentPrior, FactorGroup, LatentPrior, StructuredLatentPrior, detect_hessian_pattern
from .rw import RW1Model, RW2Model, RWModel
from .separable import SeparableModel

__all__ = [
    "LatentModel",
    "process_constraint",
    "stack_constraints",
    "ARModel",
    "AR1Model",
    "RWModel",
    "RW1Model",
    "RW2Model",
    "IIDModel",
    "FixedEffectsModel",
    "BesagModel",
    "BYM2Model",
    "CombinedModel",
    "SeparableModel",
    "CARModel",
    "generate_car_model",
    "grid_matern2_precision",
    "LatentPrior",
    "AutoDiffLatentPrior",
    "StructuredLatentPrior",
    "FactorGroup",
    "detect_hessian_pattern",
]
