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
from .fem import FEMDiscretization, MaternModel, MaternSPDE, TriangleMesh, generate_mesh
from .gmrf import GMRF, logpdf, sample
from .graphical_lasso import graphical_lasso
from .inference import (
    GAOptions,
    conditional_predictive_ordinates,
    gaussian_approximation,
    joint_gmrf,
    laplace_marginal,
    linear_condition,
    linear_predictor_marginals,
    marginal_loglikelihood,
    waic,
)
from .kl_cholesky import approximate_gmrf_kl, reverse_maximin_ordering
from .linear_maps import (
    ADJacobianMap,
    CholeskySqrtMap,
    OuterProductMap,
    SSMBidiagonalMap,
    SymmetricBlockTridiagonalMap,
    ZeroMap,
    block_tridiag_to_sparse,
    sparse_hessian_map,
    sparse_jacobian_map,
)
from .metagmrf import GMRFMetadata, MetaGMRF
from .models import (
    AR1Model,
    ARModel,
    AutoDiffLatentPrior,
    BesagModel,
    BYM2Model,
    CARModel,
    CombinedModel,
    FactorGroup,
    FixedEffectsModel,
    IIDModel,
    LatentModel,
    LatentPrior,
    RW1Model,
    RW2Model,
    RWModel,
    SeparableModel,
    StructuredLatentPrior,
    detect_hessian_pattern,
    generate_car_model,
)
from .observations import (
    AutoDiffObservationModel,
    BinomialObservations,
    CompositeObservationModel,
    ExponentialFamily,
    LinearlyTransformedObservationModel,
    NegativeBinomialObservations,
    NonlinearLeastSquaresModel,
    ObservationLikelihood,
    ObservationModel,
    ParameterizedMatrix,
    ParameterizedOffset,
    PoissonObservations,
    ZeroLikelihood,
    conditional_distribution,
)
from .parallel import pbtridiag_logdet, pbtridiag_solve, sharded_block_tridiag_solver
from .samplers import IdentityTransform, LogitTransform, LogTransform, ParamSpec, make_logdensity, run_hmc, run_nuts
from .solvers import SolverSpec, factorize
from .solvers.cg import cg_solve
from .solvers.rbmc import rbmc_var
from .sparse import SparseMatrix, SparsePattern, from_dense, from_scipy, sp_block_diag, sp_kron, spdiag, speye
from .workspace import GMRFWorkspace, WorkspacePool, make_workspace, make_workspace_pool

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
    "ADJacobianMap",
    "sparse_jacobian_map",
    "sparse_hessian_map",
    "rbmc_var",
    "cg_solve",
    "SparseMatrix",
    "SparsePattern",
    "from_dense",
    "from_scipy",
    "speye",
    "spdiag",
    "sp_block_diag",
    "sp_kron",
    "MetaGMRF",
    "GMRFMetadata",
    "GMRFWorkspace",
    "WorkspacePool",
    "make_workspace",
    "make_workspace_pool",
    "SolverSpec",
    "factorize",
    "LatentModel",
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
    "LatentPrior",
    "AutoDiffLatentPrior",
    "StructuredLatentPrior",
    "FactorGroup",
    "detect_hessian_pattern",
    "MaternModel",
    "MaternSPDE",
    "FEMDiscretization",
    "TriangleMesh",
    "generate_mesh",
    "ExponentialFamily",
    "ObservationLikelihood",
    "ObservationModel",
    "PoissonObservations",
    "BinomialObservations",
    "NegativeBinomialObservations",
    "LinearlyTransformedObservationModel",
    "ParameterizedMatrix",
    "ParameterizedOffset",
    "CompositeObservationModel",
    "AutoDiffObservationModel",
    "NonlinearLeastSquaresModel",
    "ZeroLikelihood",
    "conditional_distribution",
    "GAOptions",
    "gaussian_approximation",
    "marginal_loglikelihood",
    "laplace_marginal",
    "joint_gmrf",
    "linear_predictor_marginals",
    "waic",
    "conditional_predictive_ordinates",
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
