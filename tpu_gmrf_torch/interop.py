"""Carry objects across from NumPy arrays into the port.

Each function takes NumPy arrays (as ``np.asarray`` gives them from the JAX
package's objects) and returns the port's object on the given device (the
package's default device when none is given) and dtype. Entry order is
preserved: ``rows``/``cols`` are the pattern's canonical order, so ``data``
transfers index for index.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import default_device
from .constrained import ConstrainedGMRF
from .fem.discretization import FEMDiscretization
from .fem.mesh import TriangleMesh
from .fem.spde import MaternModel
from .gmrf import GMRF
from .observations.exponential_family import EFLikelihood
from .samplers.adaptation import DualAveragingState, WelfordState
from .samplers.hmc import HMCState
from .samplers.run import NUTSResult
from .samplers.smc import SMCResult
from .samplers.vi import ADVIResult
from .solvers.base import SolverSpec
from .sparse.matrix import SparseMatrix
from .sparse.pattern import SparsePattern

__all__ = [
    "sparse_from_numpy", "gmrf_from_numpy", "constrained_gmrf_from_numpy", "ef_likelihood_from_numpy", "hmc_state_from_numpy",
    "plan_to_numpy", "matern_model_from_numpy", "nuts_result_from_numpy", "da_state_from_numpy",
    "welford_state_from_numpy", "bsr_from_numpy", "block_tridiag_mv_from_numpy", "smc_result_from_numpy",
    "advi_result_from_numpy",
]


def _t(a, dtype, device):
    if a is None:
        return None
    return torch.tensor(np.asarray(a), dtype=dtype, device=default_device() if device is None else device)


def sparse_from_numpy(rows, cols, shape, data, *, dtype=torch.float64, device=None) -> SparseMatrix:
    pattern = SparsePattern(rows, cols, shape)
    if not np.array_equal(pattern.sort_order, np.arange(pattern.nnz)):
        raise ValueError("rows/cols must be in canonical (row, col) order, as a SparsePattern stores them")
    return SparseMatrix(_t(data, dtype, device), pattern)


def gmrf_from_numpy(mean, rows, cols, shape, data, *, solver: SolverSpec = SolverSpec(),
                    dtype=torch.float64, device=None) -> GMRF:
    Q = sparse_from_numpy(rows, cols, shape, data, dtype=dtype, device=device)
    return GMRF.from_precision(_t(mean, dtype, device), Q, solver)


def constrained_gmrf_from_numpy(mean, rows, cols, shape, data, A, e, *, solver: SolverSpec = SolverSpec(),
                                dtype=torch.float64, device=None) -> ConstrainedGMRF:
    """The port's ConstrainedGMRF of the base (mean, Q) under A x = e; data
    (nnz,) or (B, nnz)."""
    base = gmrf_from_numpy(mean, rows, cols, shape, data, solver=solver, dtype=dtype, device=device)
    return ConstrainedGMRF.create(base, _t(A, dtype, device), _t(e, dtype, device))


def ef_likelihood_from_numpy(family: str, link: str, y, params: dict | None = None, offset=None,
                             indices=None, *, dtype=torch.float64, device=None) -> EFLikelihood:
    return EFLikelihood(
        y=_t(y, dtype, device),
        params={k: _t(v, dtype, device) for k, v in (params or {}).items()},
        offset=_t(offset, dtype, device),
        indices=_t(indices, torch.long, device),
        family=family,
        link=link,
    )


def hmc_state_from_numpy(position, logdensity, grad, *, dtype=torch.float64, device=None) -> HMCState:
    return HMCState(_t(position, dtype, device), _t(logdensity, dtype, device), _t(grad, dtype, device))


def nuts_result_from_numpy(samples, logdensity, step_size, inv_mass, accept_prob, diverging, depth, *,
                           dtype=torch.float64, device=None) -> NUTSResult:
    """The fields of the reference's NUTSResult, in its order."""
    return NUTSResult(
        *(_t(a, dtype, device) for a in (samples, logdensity, step_size, inv_mass, accept_prob)),
        _t(diverging, torch.bool, device), _t(depth, torch.long, device),
    )


def smc_result_from_numpy(particles, log_evidence, num_stages, lambdas, *, dtype=torch.float64,
                          device=None) -> SMCResult:
    """The fields of the reference's SMCResult, in its order."""
    return SMCResult(_t(particles, dtype, device), _t(log_evidence, dtype, device), int(np.asarray(num_stages)),
                     _t(lambdas, dtype, device))


def advi_result_from_numpy(mean, log_std, elbo_trace, *, dtype=torch.float64, device=None) -> ADVIResult:
    """The fields of the reference's ADVIResult, in its order; e.g. a starting
    point (init, −1, an empty trace) for `samplers.vi.advi_step`."""
    return ADVIResult(*(_t(a, dtype, device) for a in (mean, log_std, elbo_trace)))


def da_state_from_numpy(log_step, log_step_avg, avg_error, mu, count, *, dtype=torch.float64,
                        device=None) -> DualAveragingState:
    """The reference's DualAveragingState, fields in its order."""
    return DualAveragingState(*(_t(a, dtype, device) for a in (log_step, log_step_avg, avg_error, mu, count)))


def welford_state_from_numpy(mean, m2, count, *, dtype=torch.float64, device=None) -> WelfordState:
    return WelfordState(_t(mean, dtype, device), _t(m2, dtype, device), _t(count, dtype, device))


def matern_model_from_numpy(nodes, triangles, *, smoothness: int = 1, bc: str = "neumann",
                            boundary_noise: float = 1e-4, diffusion_factor=None,
                            solver: SolverSpec | None = None) -> MaternModel:
    """The port's MaternModel on a given mesh (vertices (n, 2), triangles (m, 3)),
    e.g. the arrays of the reference model's ``disc.mesh``."""
    disc = FEMDiscretization(TriangleMesh(np.asarray(nodes), np.asarray(triangles)))
    return MaternModel(disc, smoothness=smoothness, bc=bc, boundary_noise=boundary_noise,
                       diffusion_factor=diffusion_factor, solver=solver)


def plan_to_numpy(plan):
    """A supernodal plan dict (nested dicts, lists, arrays, numbers) with every
    array as a NumPy array, e.g. the reference's plan for a table-by-table
    comparison with ``tpu_gmrf_torch.solvers.supernodal.supernodal_plan``."""
    if isinstance(plan, dict):
        return {k: plan_to_numpy(v) for k, v in plan.items()}
    if isinstance(plan, (list, tuple)):
        return type(plan)(plan_to_numpy(v) for v in plan)
    if hasattr(plan, "shape") and hasattr(plan, "dtype"):
        return np.asarray(plan)
    return plan


def bsr_from_numpy(blocks, n: int, bs: int, block_rows, block_cols, *, dtype=torch.float64, device=None):
    """The port's `BSRMatrix` from a reference BSR matrix's blocks
    (nblocks, bs, bs) and its plan's ``block_rows`` / ``block_cols`` (sorted
    by block row, then column): the row pointers, the transpose order and
    the transposed plan are rebuilt from them."""
    from .kernels.bsr_spmv import BSRMatrix, _BSRPlan

    br, bc = np.asarray(block_rows, np.int32), np.asarray(block_cols, np.int32)
    nb = -(-n // bs)
    if np.any(np.diff(br.astype(np.int64) * nb + bc) <= 0):
        raise ValueError("block_rows/block_cols must be sorted by (row, col) without duplicates")

    def rowptr(r):
        return np.cumsum(np.bincount(r.astype(np.int64) + 1, minlength=nb + 1), dtype=np.int32)

    t_order = np.lexsort((br, bc)).astype(np.int32)
    empty = np.zeros(0, np.int32)
    plan = _BSRPlan(n, bs, nb, br, bc, rowptr(br), empty, empty, empty, t_order)
    plan.transpose = _BSRPlan(n, bs, nb, bc[t_order], br[t_order], rowptr(bc), empty, empty, empty,
                              np.argsort(t_order).astype(np.int32), transpose=plan)
    return BSRMatrix(_t(blocks, dtype, device), plan)


def block_tridiag_mv_from_numpy(D, E, inv_perm, n: int, npad: int, *, dtype=torch.float64, device=None):
    """The port's `BlockTridiagMV` from the reference operator's fields."""
    from .solvers.banded import BlockTridiagMV

    return BlockTridiagMV(D=_t(D, dtype, device), E=_t(E, dtype, device), inv_perm=_t(inv_perm, torch.long, device),
                          n=n, npad=npad)
