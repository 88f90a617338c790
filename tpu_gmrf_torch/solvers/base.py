"""Solver dispatch: structure-specialized factorization backends.

Counterpart of ``tpu_gmrf.solvers.base``. Every backend implements
``solve(b)``, ``logdet()``, ``backward_solve(z)``, ``selinv_diag()`` and
``selinv(pattern)``; the iterative ``cg`` backend (`CGFactor`) solves only
and raises on the rest, as in the reference.

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

__all__ = ["SolverSpec", "factorize", "CGFactor", "DENSE_AUTO_MAX"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Above this dimension "auto" stops materializing dense factors.
DENSE_AUTO_MAX = 4096

_RESOLVED: dict = {}


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Static solver configuration.

    kind: "auto" | "dense" | "tridiag" | "banded" | "supernodal" | "cg".
    block: block-size multiple of the banded backend; max_width / ordering
    configure the supernodal plan; cg_tol / cg_max_iter the CG backend.
    """

    kind: str = "auto"
    block: int | None = None
    dense_max: int = DENSE_AUTO_MAX
    max_width: int = 2048
    ordering: str = "auto"
    cg_tol: float = 1e-8
    cg_max_iter: int = 2000

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


@dataclasses.dataclass(frozen=True)
class CGFactor:
    """Iterative 'factorization': preconditioned CG solves only.

    Mirrors the reference's supports_selinv=false / supports_backward_solve
    =false algorithms (src/solvers/selinv.jl:16-29): statistics that need a
    factor (logdet, sampling, selected inversion) must use a direct backend
    or the RBMC variance estimators.

    CG multiplies by the same Q hundreds of times: `hot_matvec` picks the
    formulation (K4, K13 or K14) for the pattern, once, at construction.
    """

    Q: object  # SparseMatrix, data (nnz,) or (B, nnz)
    tol: float
    max_iter: int
    matvec: object = dataclasses.field(repr=False, compare=False, default=None)

    def __post_init__(self):
        if self.matvec is None:
            from ..kernels import hot_matvec

            object.__setattr__(self, "matvec", hot_matvec(self.Q))

    @property
    def batch_shape(self):
        return tuple(self.Q.data.shape[:-1])

    def solve_info(self, b: torch.Tensor):
        """(x, iterations, relative residual) of Q x = b by Jacobi-preconditioned
        CG; b (*batch, n) or (*batch, n, k). Every right-hand side has its own
        iteration count and residual (shape of b without the n axis)."""
        from .cg import cg_solve, jacobi_preconditioner

        n, bs = self.Q.shape[0], self.batch_shape
        if b.shape[: len(bs) + 1] != bs + (n,) or b.ndim not in (len(bs) + 1, len(bs) + 2):
            raise ValueError(f"rhs of shape {tuple(b.shape)} does not match a factor of {bs} x {n}")
        M = jacobi_preconditioner(self.Q)

        def run(rows):
            return cg_solve(self.matvec, rows, preconditioner=M, tol=self.tol, max_iter=self.max_iter)

        if b.ndim == len(bs) + 1:  # one vector (per chain)
            return run(b.contiguous())
        if not bs:  # k columns of one matrix: the rows of one batched loop
            x, it, res = run(b.mT.contiguous())
            return x.mT, it, res
        cols = [run(b[..., j].contiguous()) for j in range(b.shape[-1])]  # per chain and column
        return tuple(torch.stack([c[i] for c in cols], -1) for i in range(3))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve_info(b)[0]

    def _unsupported(self, what):
        raise NotImplementedError(
            f"CG backend does not support {what}; use SolverSpec(kind="
            f"'supernodal'/'banded'/'dense') or the RBMC variance estimators"
        )

    def logdet(self):
        self._unsupported("logdet")

    def backward_solve(self, z):
        self._unsupported("backward_solve (sampling)")

    def selinv_diag(self):
        self._unsupported("selected inversion")

    def selinv(self, pattern):
        self._unsupported("selected inversion")


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
    if spec.kind == "cg":
        return CGFactor(Q=Q, tol=spec.cg_tol, max_iter=spec.cg_max_iter)
    raise ValueError(f"unknown solver kind: {spec.kind}")
