"""PyTorch/CUDA port of tpu_gmrf for one NVIDIA H100.

Module paths and public names mirror ``tpu_gmrf``. Chains are a leading
batch axis B written out (no vmap): sparse data is (nnz,) or (B, nnz) over
one pattern, latent vectors are (B, n) and θ entries (B,). The hot path
runs on four hand-written CUDA kernels (``tpu_gmrf_torch.kernels``), built
with nvcc at first use on a CUDA tensor; CPU tensors take their plain
PyTorch versions. This package never imports JAX.
"""

from .gmrf import GMRF
from .inference import GAOptions, gaussian_approximation, laplace_marginal, marginal_loglikelihood
from .models import AR1Model, ARModel, LatentModel
from .observations import ExponentialFamily
from .solvers import SolverSpec, factorize
from .sparse import SparseMatrix, SparsePattern

__all__ = [
    "GMRF",
    "SparseMatrix",
    "SparsePattern",
    "SolverSpec",
    "factorize",
    "LatentModel",
    "ARModel",
    "AR1Model",
    "ExponentialFamily",
    "GAOptions",
    "gaussian_approximation",
    "marginal_loglikelihood",
    "laplace_marginal",
]
