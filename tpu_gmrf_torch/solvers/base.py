"""Solver dispatch: structure-specialized factorization backends.

Counterpart of ``tpu_gmrf.solvers.base``. Every backend implements
``solve(b)``, ``logdet()``, ``backward_solve(z)``, ``selinv_diag()`` and
``selinv(pattern)``; the iterative ``cg`` backend (`CGFactor`) solves only
and raises on the rest, as in the reference.

Every direct backend's factor is a `DirectFactor`: its ``solve`` goes
through `FactorSolve`, which carries the gradient to b and to the data Q was
factored from (x̄ ↦ b̄ = Q⁻¹x̄ by the same factor, Q̄ = −b̄xᵀ on Q's entries),
and its selected inverse (``selinv_diag``, ``selinv``, ``selinv_dot``)
through `SelectedInverse`, whose backward is Q̄ = −P_Q(Σ S Σ) for the
cotangent S placed on Σ's entries, from the backend's tangent pass. Both
backwards are built from differentiable pieces (the Functions themselves and
torch ops), so second derivatives (``create_graph=True``) go through the
same kernels; each Function has a ``jvp`` for forward mode. The statistics
that need the factor's own derivative (sampling, the triangular solves,
``sqrt_matvec``) have no backward yet: `DirectFactor.NO_BACKWARD` lists
them, and they raise while grad mode is on and Q's data requires a gradient
(`no_backward`), instead of returning a tensor cut from the graph.

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
import functools

import numpy as np
import torch

__all__ = ["SolverSpec", "factorize", "CGFactor", "DirectFactor", "FactorSolve", "SelectedInverse", "DENSE_AUTO_MAX",
           "no_backward", "no_double_backward", "pattern_solve_grad", "symmetric_weights"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Above this dimension "auto" stops materializing dense factors.
DENSE_AUTO_MAX = 4096

_RESOLVED: dict = {}
_INDEX: dict = {}


def _tracked(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def no_backward(what: str, *inputs) -> None:
    """Raise while grad mode is on and one of a factor's inputs requires a
    gradient: `what` has no backward in this port (the reference gets one by
    AD through its Cholesky and Takahashi recursions)."""
    if _tracked(*inputs):
        raise NotImplementedError(
            f"{what} has no backward in this port; detach Q's data (or use torch.no_grad()) to compute it"
        )


def no_double_backward(what: str) -> None:
    """Raise inside a backward asked to build its own graph (``create_graph=True``)
    whose result would not be differentiable: `what` has no derivative of
    that order in this port."""
    if torch.is_grad_enabled():
        raise NotImplementedError(f"{what} has no second derivative in this port (create_graph=True)")


class FactorSolve(torch.autograd.Function):
    """x = Q⁻¹b by a direct backend's factor, differentiable in b and in the
    tensors Q was factored from.

    apply(factor, b, *factor.grad_inputs): the factor's ``_solve_both(b)``
    runs its kernel with no graph. Backward: b̄ = Q⁻¹x̄ through this Function
    again (Q is symmetric), and ``factor._input_grads(b̄, x)`` maps
    Q̄ = −b̄xᵀ onto the inputs with torch ops, with the convention of the
    backend's logdet backward; so the backward is differentiable. jvp:
    ẋ = Q⁻¹(ḃ − Q̇x)."""

    @staticmethod
    def forward(ctx, factor, b, *inputs):
        x = factor._solve_both(b)
        ctx.factor = factor
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return x

    @staticmethod
    def backward(ctx, gx):
        (x,) = ctx.saved_tensors
        factor = ctx.factor
        gb = FactorSolve.apply(factor, gx.contiguous(), *factor.grad_inputs)
        if any(ctx.needs_input_grad[2:]):
            grads = factor._input_grads(gb, x)
        else:
            grads = (None,) * (len(ctx.needs_input_grad) - 2)
        return (None, gb if ctx.needs_input_grad[1] else None, *grads)

    @staticmethod
    def jvp(ctx, _factor, db, *dinputs):
        (x,) = ctx.saved_tensors
        factor = ctx.factor
        rhs = torch.zeros_like(x) if db is None else db
        if any(t is not None for t in dinputs):
            rhs = rhs - factor._tangent_matvec(dinputs, x)
        return factor._solve_both(rhs.contiguous())


class SelectedInverse(torch.autograd.Function):
    """Σ = Q⁻¹ at the entries `where` (an int n: the diagonal; or a pattern)
    of a direct backend's factor, as a function of the data Q was factored
    from: (B, m).

    apply(factor, where, *factor.grad_inputs). Backward: for the cotangent
    S on `where`'s entries, data̅ = −(Σ·sym(S)·Σ) at Q's entries, sym(S) =
    (S + Sᵀ)/2; jvp: Σ̇ = −Σ·Q̇·Σ at `where`, Q̇ = sym(data̅'s tangent). Both
    are the backend's tangent pass (``factor._sigma_tangent``), the map
    T ↦ −P(Σ sym(T) Σ) being its own adjoint. The backward is not
    differentiable again: Σ's second derivative (the logdet's third) raises."""

    @staticmethod
    def forward(ctx, factor, where, *inputs):
        ctx.factor, ctx.where = factor, where
        return factor._sigma(where)

    @staticmethod
    def backward(ctx, gz):
        no_double_backward("the selected inverse's derivative")
        factor = ctx.factor
        return None, None, factor._sigma_tangent(gz.contiguous(), ctx.where, factor.pattern)

    @staticmethod
    def jvp(ctx, _factor, _where, *dinputs):
        factor = ctx.factor
        return factor._sigma_tangent(factor._tangent_data(dinputs), factor.pattern, ctx.where)


def symmetric_weights(where, device, dtype) -> torch.Tensor | None:
    """The weights of sym(T) = (T + Tᵀ)/2 on the lower entries of a symmetric
    matrix for T on `where`'s entries: ½ off the diagonal, 1 on it (None for
    the diagonal, an int)."""
    if isinstance(where, int):
        return None
    key = (where, "symw", str(device), dtype)
    w = _INDEX.get(key)
    if w is None:
        w = _INDEX[key] = torch.as_tensor(np.where(where.rows == where.cols, 1.0, 0.5), dtype=dtype, device=device)
    return w


def pattern_solve_grad(gb: torch.Tensor, x: torch.Tensor, pattern, B: int) -> torch.Tensor:
    """The data gradient (B, nnz) of a solve on a symmetric pattern whose two
    stored triangles are averaged before factoring (the reference's
    convention): entry p at (r, c) gets −½ Σ_k (b̄[r,k] x[c,k] + b̄[c,k] x[r,k]).
    gb, x: (*batch, n) or (*batch, n, k) with prod(batch) = B."""
    n = pattern.shape[0]
    key = (pattern, str(x.device))
    rc = _INDEX.get(key)
    if rc is None:
        rc = _INDEX[key] = tuple(torch.tensor(np.asarray(a), dtype=torch.long, device=x.device)
                                 for a in (pattern.rows, pattern.cols))
    rows, cols = rc
    gb, x = gb.reshape(B, n, -1), x.reshape(B, n, -1)
    return -0.5 * ((gb[:, rows] * x[:, cols]).sum(-1) + (gb[:, cols] * x[:, rows]).sum(-1))


def _guarded(what: str, method):
    @functools.wraps(method)
    def guarded(self, *args, **kwargs):
        no_backward(what, *self.grad_inputs)
        return method(self, *args, **kwargs)

    return guarded


class DirectFactor:
    """What the direct backends' factors share.

    A subclass computes x = Q⁻¹b in ``_solve_both(b)`` with its kernel, and
    keeps the tensor ``data`` (B, nnz) it factored on ``pattern``, its two
    stored triangles averaged: Q̄ then maps onto data by `pattern_solve_grad`.
    It gives Σ at an int n (the diagonal) or a pattern's entries in
    ``_sigma(where)``, and ``_sigma_tangent(t, p_in, p_out)``: −Σ·sym(T)·Σ at
    p_out's entries for T given by t (B, m) on p_in's, from its kernels and
    with no graph. The tridiagonal backend, factored from its rows a and c,
    overrides the input side (`grad_inputs`, `_input_grads`,
    `_tangent_matvec`, `_selected`). Each method named in ``NO_BACKWARD``
    that a subclass defines raises while grad mode is on and one of
    `grad_inputs` requires a gradient."""

    NO_BACKWARD = {
        "forward_solve": "forward_solve",
        "backward_solve": "backward_solve (sampling)",
        "sqrt_matvec": "sqrt_matvec",
    }

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name, what in cls.NO_BACKWARD.items():
            if name in cls.__dict__:
                setattr(cls, name, _guarded(what, cls.__dict__[name]))

    @property
    def grad_inputs(self) -> tuple:
        """The tensors Q was factored from: the differentiable inputs of
        `FactorSolve` and `SelectedInverse`."""
        return (self.data,)

    def _input_grads(self, gb: torch.Tensor, x: torch.Tensor) -> tuple:
        return (pattern_solve_grad(gb, x, self.pattern, self.data.shape[0]),)

    def _tangent_data(self, dinputs) -> torch.Tensor:
        """The tangent of `data` from the tangents of `grad_inputs` (zeros for none)."""
        (dd,) = dinputs
        return torch.zeros_like(self.data) if dd is None else dd

    def _tangent_matvec(self, dinputs, x: torch.Tensor) -> torch.Tensor:
        """Q̇ x for the tangents of `grad_inputs`, Q̇ = sym(data's tangent); x as `solve` takes it."""
        from ..sparse.matrix import SparseMatrix

        B, n = self.data.shape[0], self.pattern.shape[0]
        xr = x.reshape(B, n, -1)
        Qd = SparseMatrix(self._tangent_data(dinputs), self.pattern).symmetrize()
        cols = [Qd.matvec(xr[..., j].contiguous()) for j in range(xr.shape[-1])]
        return torch.stack(cols, -1).reshape(x.shape)

    def _selected(self, where) -> torch.Tensor:
        """Σ at `where`'s entries, (B, m), differentiable in `grad_inputs`."""
        return SelectedInverse.apply(self, where, *self.grad_inputs)

    def selinv_diag(self) -> torch.Tensor:
        return self._selected(self.n).reshape(tuple(self.batch_shape) + (self.n,))

    def selinv(self, pattern):
        """Entries of Q⁻¹ on `pattern` (used for ∂logdet(Q)/∂Q)."""
        from ..sparse.matrix import SparseMatrix

        if tuple(pattern.shape) != (self.n, self.n):
            raise ValueError(f"pattern of shape {pattern.shape} does not match a factor of {self.n} x {self.n}")
        z = self._selected(pattern)
        return SparseMatrix(z.reshape(tuple(self.batch_shape) + (pattern.nnz,)), pattern)

    def selinv_dot(self, other) -> torch.Tensor:
        """tr(Q⁻¹ · other) per chain, for other on any pattern: one K5 sum of
        Σ's values times other's, differentiable in both."""
        from ..sparse.matrix import sp_dot

        if tuple(other.shape) != (self.n, self.n):
            raise ValueError(f"pattern of shape {other.shape} does not match a factor of {self.n} x {self.n}")
        z = self._selected(other.pattern)
        y = other.data if other.data.ndim == 1 else other.data.reshape(-1, other.nnz)
        return sp_dot(z, y).reshape(tuple(self.batch_shape))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Q x = b for b (*batch, n) or (*batch, n, k); differentiable in b and
        in Q's data through `FactorSolve`."""
        return FactorSolve.apply(self, b, *self.grad_inputs)


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
        """Q x = b; raises while a gradient is asked of Q or b (the reference's
        CG is a ``while_loop``, which ``jax.grad`` refuses)."""
        no_backward("the CG solve", self.Q.data, b)
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
