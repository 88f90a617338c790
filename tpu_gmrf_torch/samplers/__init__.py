from .adaptation import da_init, da_update, warmup_schedule, welford_init, welford_update, welford_variance
from .hmc import HMCState, hmc_init, hmc_kernel, hmc_transition, leapfrog, value_and_grad
from .nuts import NUTSDraws, NUTSInfo, nuts_kernel, nuts_transition
from .checkpoint import run_nuts_checkpointed
from .run import NUTSResult, run_hmc, run_nuts
from .smc import SMCResult, run_smc
from .transforms import (
    IdentityTransform,
    LogitTransform,
    LogTransform,
    ParamSpec,
    Transform,
    make_logdensity,
)
from .vi import ADVIResult, run_advi

__all__ = [
    "HMCState",
    "hmc_init",
    "hmc_kernel",
    "hmc_transition",
    "leapfrog",
    "value_and_grad",
    "nuts_kernel",
    "nuts_transition",
    "NUTSInfo",
    "NUTSDraws",
    "run_nuts",
    "run_hmc",
    "NUTSResult",
    "da_init",
    "da_update",
    "warmup_schedule",
    "welford_init",
    "welford_update",
    "welford_variance",
    "Transform",
    "IdentityTransform",
    "LogTransform",
    "LogitTransform",
    "ParamSpec",
    "make_logdensity",
    "run_advi",
    "ADVIResult",
    "run_smc",
    "SMCResult",
    "run_nuts_checkpointed",
]
