"""A regular-grid precision at any size, for scale checks and the CG path.

`grid_matern2_precision(m)` is the Matérn-α=2-class precision Q = KᵀK with
K = 2I + L on the m×m four-neighbour grid, n = m². L = diag(W·1) − W, where
W holds each grid edge once, from the lower to the higher node index (so K
is not symmetric; Q is, with about 7 entries per row). It is the
reference's large-n proof point (``tests/test_scale.py`` there builds the
same matrix); it is well conditioned, so CG converges in tens of iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern

__all__ = ["grid_matern2_precision"]


def grid_matern2_precision(m: int, dtype=torch.float32, device=None) -> SparseMatrix:
    import scipy.sparse as sp

    n = m * m
    idx = np.arange(n).reshape(m, m)
    pairs = np.concatenate(
        [
            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
        ]
    )
    W = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    K = (2.0 * sp.eye(n) + L).tocsr()
    Q = (K.T @ K).tocoo()
    pat = SparsePattern(Q.row, Q.col, (n, n))
    data = torch.tensor(Q.data[pat.sort_order], dtype=dtype, device=default_device() if device is None else device)
    return SparseMatrix(data, pat)
