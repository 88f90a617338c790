from .ar import AR1Model, ARModel
from .base import LatentModel, process_constraint

__all__ = ["LatentModel", "process_constraint", "ARModel", "AR1Model"]
