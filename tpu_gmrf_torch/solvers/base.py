"""Solver dispatch: structure-specialized factorization backends.

Counterpart of ``tpu_gmrf.solvers.base``. Every backend implements
``solve(b)``, ``logdet()``, ``backward_solve(z)``, ``selinv_diag()`` and
``selinv(pattern)``. Only the tridiagonal backend is ported; the other
kinds raise `NotImplementedError` naming the ROADMAP item that ports them.

The reference wraps its backends in ``mxu_f32`` because TPU matmuls default
to bf16 passes. The port has no such wrapper: TF32, the card's reduced
matmul precision, is switched off here, once, for the whole package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SolverSpec", "factorize", "DENSE_AUTO_MAX"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Above this dimension "auto" stops materializing dense factors.
DENSE_AUTO_MAX = 4096

_NOT_PORTED = {
    "dense": "ROADMAP queue 2, item 2.5 (solvers/dense.py)",
    "banded": "ROADMAP queue 2, item 2.14 (solvers/banded.py)",
    "supernodal": "ROADMAP queue 2, items 2.6-2.13 (solvers/supernodal.py)",
    "cg": "ROADMAP queue 2, item 2.21 (solvers/cg.py)",
}


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Static solver configuration.

    kind: "auto" | "dense" | "tridiag" | "banded" | "supernodal" | "cg".
    The reference's per-backend fields (block, max_width, ordering,
    cg_tol, cg_max_iter) arrive with their backends.
    """

    kind: str = "auto"
    dense_max: int = DENSE_AUTO_MAX

    def resolve(self, pattern) -> "SolverSpec":
        if self.kind != "auto":
            return self
        if _is_tridiagonal(pattern):
            return dataclasses.replace(self, kind="tridiag")
        if pattern.shape[0] <= self.dense_max:
            return dataclasses.replace(self, kind="dense")
        raise NotImplementedError(
            "choosing banded vs supernodal for a large sparse pattern is not ported "
            "(ROADMAP queue 2, items 2.6-2.14)"
        )


def _is_tridiagonal(pattern) -> bool:
    return bool(np.all(np.abs(pattern.rows.astype(np.int64) - pattern.cols) <= 1))


def factorize(Q, spec: SolverSpec = SolverSpec()):
    """Factorize symmetric positive-definite sparse precision matrices
    (data (nnz,) or (B, nnz))."""
    spec = spec.resolve(Q.pattern)
    if spec.kind == "tridiag":
        from .tridiag import tridiag_factorize

        return tridiag_factorize(Q)
    if spec.kind in _NOT_PORTED:
        raise NotImplementedError(f"solver kind {spec.kind!r} is not ported yet: {_NOT_PORTED[spec.kind]}")
    raise ValueError(f"unknown solver kind: {spec.kind}")
