from .hmc import HMCState, hmc_init, hmc_kernel, hmc_transition, leapfrog, value_and_grad
from .transforms import (
    IdentityTransform,
    LogitTransform,
    LogTransform,
    ParamSpec,
    Transform,
    make_logdensity,
)

__all__ = [
    "HMCState",
    "hmc_init",
    "hmc_kernel",
    "hmc_transition",
    "leapfrog",
    "value_and_grad",
    "Transform",
    "IdentityTransform",
    "LogTransform",
    "LogitTransform",
    "ParamSpec",
    "make_logdensity",
]
