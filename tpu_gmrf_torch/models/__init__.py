from .ar import AR1Model, ARModel
from .base import LatentModel, process_constraint
from .grid import grid_matern2_precision

__all__ = ["LatentModel", "process_constraint", "ARModel", "AR1Model", "grid_matern2_precision"]
