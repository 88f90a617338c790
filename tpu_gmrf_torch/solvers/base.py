"""Solver dispatch: structure-specialized factorization backends.

Counterpart of ``tpu_gmrf.solvers.base``. Every backend implements
``solve(b)``, ``logdet()``, ``backward_solve(z)``, ``selinv_diag()`` and
``selinv(pattern)``. The tridiagonal, dense, banded and supernodal backends
are ported (the banded one without its selected inverse); ``cg`` raises
`NotImplementedError` naming the ROADMAP item that ports it.

``kind="auto"`` resolves as the reference does: tridiagonal patterns to
``tridiag``, n ≤ dense_max to ``dense``, larger patterns to ``banded`` or
``supernodal`` by the reference's cost model (`_large_sparse_kind`, its
constants unchanged). The reference resolves once per trace; the port
calls `factorize` at every Newton iteration, so the resolution is cached
per (pattern, spec).

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
    "cg": "ROADMAP queue 2, item 2.21 (solvers/cg.py)",
}
_RESOLVED: dict = {}


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Static solver configuration.

    kind: "auto" | "dense" | "tridiag" | "banded" | "supernodal" | "cg".
    block: block-size multiple of the banded backend; max_width / ordering
    configure the supernodal plan. The reference's CG fields (cg_tol,
    cg_max_iter) arrive with that backend.
    """

    kind: str = "auto"
    block: int | None = None
    dense_max: int = DENSE_AUTO_MAX
    max_width: int = 2048
    ordering: str = "auto"

    def resolve(self, pattern) -> "SolverSpec":
        if self.kind != "auto":
            return self
        key = (pattern, self)
        spec = _RESOLVED.get(key)
        if spec is None:
            if _is_tridiagonal(pattern):
                kind = "tridiag"
            elif pattern.shape[0] <= self.dense_max:
                kind = "dense"
            else:
                kind = _large_sparse_kind(pattern, self)
            spec = _RESOLVED[key] = dataclasses.replace(self, kind=kind)
        return spec


def _large_sparse_kind(pattern, spec: "SolverSpec") -> str:
    """Choose banded vs supernodal for a large unstructured pattern.

    The reference's cost model, constants unchanged (they were fitted to
    the TPU; refitting them on the H100 is an open question): banded does
    n·b² work, regular; the supernodal backend follows the fill (Σ
    colcount² work) plus a per-bucket dispatch charge.
    """
    from .banded import banded_plan
    from .supernodal import supernodal_symbolic_summary

    try:
        bplan = banded_plan(pattern, None)
        banded_flops = float(bplan["npad"]) * float(bplan["s"]) ** 2
    except Exception:
        return "supernodal"
    try:
        summ = supernodal_symbolic_summary(pattern, spec.max_width, spec.ordering)
    except Exception:
        return "banded"
    supernodal_cost = summ["flops"] * 4.0 + summ["nbuckets"] * 2.0e7
    if supernodal_cost < banded_flops:
        return "supernodal"
    return "banded"


def _is_tridiagonal(pattern) -> bool:
    return bool(np.all(np.abs(pattern.rows.astype(np.int64) - pattern.cols) <= 1))


def factorize(Q, spec: SolverSpec = SolverSpec()):
    """Factorize symmetric positive-definite sparse precision matrices
    (data (nnz,) or (B, nnz))."""
    spec = spec.resolve(Q.pattern)
    if spec.kind == "dense":
        from .dense import dense_factorize

        return dense_factorize(Q)
    if spec.kind == "banded":
        from .banded import banded_factorize

        return banded_factorize(Q, spec.block)
    if spec.kind == "tridiag":
        from .tridiag import tridiag_factorize

        return tridiag_factorize(Q)
    if spec.kind == "supernodal":
        from .supernodal import supernodal_factorize

        return supernodal_factorize(Q, spec.max_width, spec.ordering)
    if spec.kind in _NOT_PORTED:
        raise NotImplementedError(f"solver kind {spec.kind!r} is not ported yet: {_NOT_PORTED[spec.kind]}")
    raise ValueError(f"unknown solver kind: {spec.kind}")
