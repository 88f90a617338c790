"""`hot_matvec`: the repeated-multiply formulation for a fixed sparse matrix.

Counterpart of ``tpu_gmrf.kernels.hot_matvec`` (``kernels/__init__.py:20``).
Three formulations multiply by the same Q: the CSR kernel K4 (`Q.matvec`),
the dense block-tridiagonal kernel K13 (`block_tridiag_matvec`) and the BSR
kernel K14 (`bsr_from_sparse(Q).matvec`). The dispatch rule is the
reference's: its cost model divides the bytes each of the two blocked
formulations streams by a rate, and the two rates are this card's own (see
below), not the reference's TPU measurements. All three take x (n,) or rows
(k, n).
"""

from __future__ import annotations

import numpy as np
import torch

from .bsr_spmv import best_block_size, bsr_from_sparse

__all__ = ["hot_matvec"]

# The rule's two rates, in its own terms: the bytes its cost model counts
# for a formulation (K13: the dense blocks, once; K14: the BSR blocks, three
# times, as the reference's rule counts them) over the formulation's device
# time per multiply, on the 100x100-point Matérn α=2 operator (n=14058, k=8
# vectors, float32): `chip_smoke.py` phase 12 on an NVIDIA H100 80GB HBM3 at
# a 700.00 W power limit, the device time of 64 chained multiplies from a
# torch.profiler trace (K13: its three launches), K13 87.3 MB of blocks
# (s=768, K=19) in 0.0572 ms, K14 3 x 10.6 MB (bs=8, 41514 blocks) in
# 0.0287 ms. With these the rule picks BSR there and at the 316x316 grid
# (n=99856); of the two it chooses between, that is the faster measured.
_DENSE_BYTES_PER_S = 1.527e12
_GATHER_BYTES_PER_S = 1.107e12


def hot_matvec(Q, min_nnz: int = 50_000):
    """Best repeated-multiply path for a fixed sparse matrix. Use at any call
    site that multiplies by the SAME matrix many times (CG iterations, RBMC
    sample batches, power iterations). The returned callable takes x (n,) or
    rows (k, n); with Q.data (B, nnz), x (B, n), one vector per chain.

    Dispatch (from cached symbolic plans):
    - small nnz → the CSR kernel K4 (`Q.matvec`);
    - RCM-banded patterns where streaming the dense block-tridiagonal
      storage beats the blocked alternative → `block_tridiag_matvec` (K13);
    - otherwise BSR (dense (bs, bs) blocks, K14).
    """
    if Q.nnz < min_nnz:
        return Q.matvec
    from ..solvers.banded import banded_plan, block_tridiag_matvec

    bs = best_block_size(Q.pattern)
    nb = -(-Q.shape[0] // bs)
    nblocks = len(np.unique((Q.pattern.rows // bs).astype(np.int64) * nb + Q.pattern.cols // bs))
    bsr_cost = 3.0 * nblocks * bs * bs * 4 / _GATHER_BYTES_PER_S
    # block-tridiag storage keeps only the lower triangle and mirrors it, so
    # it computes the *symmetrized* product: require a symmetric pattern AND
    # symmetric values (checked on the device: one readback)
    symmetric_vals = False
    if Q.pattern.is_symmetric:
        v = Q.data.detach()
        tperm = torch.as_tensor(np.asarray(Q.pattern.transpose_perm, np.int64), device=v.device)
        symmetric_vals = bool(torch.allclose(v, v[..., tperm], rtol=1e-6, atol=0.0))
    bt_cost = None
    if symmetric_vals:
        try:
            plan = banded_plan(Q.pattern, None)
        except ValueError:
            plan = None
        if plan is not None:
            chains = 1 if Q.data.ndim == 1 else Q.data.shape[0]
            dense_bytes = (2 * plan["K"] - 1) * plan["s"] ** 2 * 4
            # memory ceiling: dense storage can inflate nnz 100x+ on wide-band
            # patterns; cap both absolute footprint (of all chains) and the inflation ratio
            if chains * dense_bytes <= 2e9 and dense_bytes <= 200 * (Q.nnz * 4):
                bt_cost = dense_bytes / _DENSE_BYTES_PER_S
    if bt_cost is not None and bt_cost < bsr_cost:
        return block_tridiag_matvec(Q)
    return bsr_from_sparse(Q, bs=bs).matvec
