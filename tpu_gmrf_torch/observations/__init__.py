from .base import ObservationLikelihood, ObservationModel
from .exponential_family import (
    BinomialObservations,
    EFLikelihood,
    ExponentialFamily,
    IdentityLink,
    LogitLink,
    LogLink,
    NegativeBinomialObservations,
    PoissonObservations,
    Predictive,
    apply_invlink,
    apply_link,
    conditional_distribution,
)
from .linearly_transformed import (
    LinearlyTransformedLikelihood,
    LinearlyTransformedObservationModel,
    ParameterizedMatrix,
    ParameterizedOffset,
)
from .autodiff import AutoDiffLikelihood, AutoDiffObservationModel, NonlinearLeastSquaresModel, ZeroLikelihood
from .composite import CompositeLikelihood, CompositeObservationModel
from .structured import ObsFactorGroup, StructuredLikelihood, StructuredObservationModel

__all__ = [
    "ObservationModel",
    "ObservationLikelihood",
    "ExponentialFamily",
    "EFLikelihood",
    "Predictive",
    "apply_link",
    "apply_invlink",
    "conditional_distribution",
    "IdentityLink",
    "LogLink",
    "LogitLink",
    "PoissonObservations",
    "BinomialObservations",
    "NegativeBinomialObservations",
    "LinearlyTransformedObservationModel",
    "LinearlyTransformedLikelihood",
    "ParameterizedMatrix",
    "ParameterizedOffset",
    "AutoDiffObservationModel",
    "AutoDiffLikelihood",
    "NonlinearLeastSquaresModel",
    "ZeroLikelihood",
    "CompositeObservationModel",
    "CompositeLikelihood",
    "StructuredObservationModel",
    "StructuredLikelihood",
    "ObsFactorGroup",
]
