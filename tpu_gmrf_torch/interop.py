"""Carry objects across from NumPy arrays into the port.

Each function takes NumPy arrays (as ``np.asarray`` gives them from the JAX
package's objects) and returns the port's object on the given device and
dtype. Entry order is preserved: ``rows``/``cols`` are the pattern's
canonical order, so ``data`` transfers index for index.
"""

from __future__ import annotations

import numpy as np
import torch

from .gmrf import GMRF
from .observations.exponential_family import EFLikelihood
from .samplers.hmc import HMCState
from .solvers.base import SolverSpec
from .sparse.matrix import SparseMatrix
from .sparse.pattern import SparsePattern

__all__ = ["sparse_from_numpy", "gmrf_from_numpy", "ef_likelihood_from_numpy", "hmc_state_from_numpy"]


def _t(a, dtype, device):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, device=device)


def sparse_from_numpy(rows, cols, shape, data, *, dtype=torch.float64, device="cpu") -> SparseMatrix:
    pattern = SparsePattern(rows, cols, shape)
    if not np.array_equal(pattern.sort_order, np.arange(pattern.nnz)):
        raise ValueError("rows/cols must be in canonical (row, col) order, as a SparsePattern stores them")
    return SparseMatrix(_t(data, dtype, device), pattern)


def gmrf_from_numpy(mean, rows, cols, shape, data, *, solver: SolverSpec = SolverSpec(),
                    dtype=torch.float64, device="cpu") -> GMRF:
    Q = sparse_from_numpy(rows, cols, shape, data, dtype=dtype, device=device)
    return GMRF.from_precision(_t(mean, dtype, device), Q, solver)


def ef_likelihood_from_numpy(family: str, link: str, y, params: dict | None = None, offset=None,
                             indices=None, *, dtype=torch.float64, device="cpu") -> EFLikelihood:
    return EFLikelihood(
        y=_t(y, dtype, device),
        params={k: _t(v, dtype, device) for k, v in (params or {}).items()},
        offset=_t(offset, dtype, device),
        indices=_t(indices, torch.long, device),
        family=family,
        link=link,
    )


def hmc_state_from_numpy(position, logdensity, grad, *, dtype=torch.float64, device="cpu") -> HMCState:
    return HMCState(_t(position, dtype, device), _t(logdensity, dtype, device), _t(grad, dtype, device))
