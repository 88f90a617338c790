"""PyTorch/CUDA port of tpu_gmrf for one NVIDIA H100.

Module paths and public names mirror ``tpu_gmrf``. Chains are a leading
batch axis B written out (no vmap): sparse data is (nnz,) or (B, nnz) over
one pattern, latent vectors are (B, n) and θ entries (B,). The hot path
runs on hand-written CUDA kernels (``tpu_gmrf_torch.kernels``), built
with nvcc at first use on a CUDA tensor; CPU tensors take their plain
PyTorch versions. Tensors a caller passes keep their device; Python
numbers and NumPy arrays go to the default device, ``"cuda"`` unless
`set_default_device` says otherwise. This package never imports JAX.
"""

from ._device import default_device, set_default_device
from .constrained import ConstrainedGMRF
from .fem import MaternModel
from .gmrf import GMRF, logpdf, sample
from .graphical_lasso import graphical_lasso
from .inference import GAOptions, gaussian_approximation, laplace_marginal, linear_condition, marginal_loglikelihood
from .kl_cholesky import approximate_gmrf_kl, reverse_maximin_ordering
from .linear_maps import (
    CholeskySqrtMap,
    OuterProductMap,
    SSMBidiagonalMap,
    SymmetricBlockTridiagonalMap,
    ZeroMap,
    block_tridiag_to_sparse,
)
from .models import AR1Model, ARModel, LatentModel
from .observations import ExponentialFamily
from .parallel import pbtridiag_logdet, pbtridiag_solve, sharded_block_tridiag_solver
from .samplers import IdentityTransform, LogitTransform, LogTransform, ParamSpec, make_logdensity, run_hmc, run_nuts
from .solvers import SolverSpec, factorize
from .solvers.cg import cg_solve
from .solvers.rbmc import rbmc_var
from .sparse import SparseMatrix, SparsePattern, from_dense, from_scipy, speye

__all__ = [
    "set_default_device",
    "default_device",
    "GMRF",
    "logpdf",
    "sample",
    "CholeskySqrtMap",
    "OuterProductMap",
    "SSMBidiagonalMap",
    "SymmetricBlockTridiagonalMap",
    "ZeroMap",
    "block_tridiag_to_sparse",
    "rbmc_var",
    "cg_solve",
    "SparseMatrix",
    "SparsePattern",
    "from_dense",
    "from_scipy",
    "speye",
    "SolverSpec",
    "factorize",
    "LatentModel",
    "ARModel",
    "AR1Model",
    "MaternModel",
    "ExponentialFamily",
    "GAOptions",
    "gaussian_approximation",
    "marginal_loglikelihood",
    "laplace_marginal",
    "IdentityTransform",
    "LogitTransform",
    "LogTransform",
    "ParamSpec",
    "make_logdensity",
    "run_hmc",
    "run_nuts",
    "ConstrainedGMRF",
    "linear_condition",
    "approximate_gmrf_kl",
    "reverse_maximin_ordering",
    "graphical_lasso",
    "pbtridiag_solve",
    "pbtridiag_logdet",
    "sharded_block_tridiag_solver",
]
