from .base import ObservationLikelihood, ObservationModel
from .exponential_family import (
    BinomialObservations,
    EFLikelihood,
    ExponentialFamily,
    NegativeBinomialObservations,
    PoissonObservations,
)

__all__ = [
    "ObservationModel",
    "ObservationLikelihood",
    "ExponentialFamily",
    "EFLikelihood",
    "PoissonObservations",
    "BinomialObservations",
    "NegativeBinomialObservations",
]
