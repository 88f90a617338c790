"""Factorization-reuse workspace layer (the reference's vocabulary).

Counterpart of ``tpu_gmrf.workspace`` (reference
src/workspace/gmrf_workspace.jl:31-289, workspace_pool.jl:44-62): a
workspace freezes the pattern prior ∪ observation Hessian once, so every
numeric factorization at a new θ reuses the symbolic work cached per
pattern (the supernodal plan, the banded ordering, the K5 plans):

    ws = make_workspace(model, obs_hessian="diag")     # symbolic once
    for theta in grid:
        prior = ws.evaluate(**theta)                    # pattern-padded GMRF
        post = gaussian_approximation(prior, obs_lik)   # numeric-only work

`WorkspacePool` hands out the one shared workspace (it holds no mutable
state). Its `batch_evaluate` is the reference's ``lax.map(...,
batch_size)``: the θ arrays are cut into chunks of `batch_size` along the
chain axis, each chunk is one batched evaluation (`fn` receives a GMRF with
one chain per θ of the chunk and returns tensors with that chain axis
first), and the results are concatenated.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._device import as_tensor
from .constrained import ConstrainedGMRF
from .gmrf import GMRF
from .solvers.base import SolverSpec, factorize
from .sparse.matrix import SparseMatrix
from .sparse.pattern import SparsePattern, diag_pattern, union_patterns

__all__ = ["GMRFWorkspace", "WorkspacePool", "make_workspace", "make_workspace_pool"]


@dataclasses.dataclass
class GMRFWorkspace:
    """The frozen joint pattern (prior ∪ observation Hessian) and the
    resolved solver spec."""

    model: Any
    pattern: SparsePattern
    solver: SolverSpec = dataclasses.field(default_factory=SolverSpec)

    def factorize(self, Q: SparseMatrix):
        """Numeric factorization of Q padded to the workspace pattern."""
        return factorize(Q.pad_to(self.pattern), self.solver)

    def evaluate(self, **theta):
        """The latent model at θ on the workspace pattern: a GMRF, or a
        ConstrainedGMRF around it when the model has constraints. (The
        reference materializes model(**θ) first and rebuilds it; under its
        jit the first factorization is dead code, so this skips it.)"""
        Q = self.model.precision(**theta).pad_to(self.pattern)
        base = GMRF.from_precision(self.model.mean(**theta), Q, self.solver)
        cons = self.model.constraints()
        if cons is None:
            return base
        return ConstrainedGMRF.create(base, *cons)


def _concat(parts: list):
    """Concatenate chunk results along their first axis (tensors, or tuples,
    lists and dicts of them)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, 0)
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    return type(first)(_concat(list(col)) for col in zip(*parts))


class WorkspacePool:
    """The reference's pool API (workspace_pool.jl:44-62); `checkout` returns
    the shared workspace."""

    def __init__(self, workspace: GMRFWorkspace, size: int = 1):
        self.workspace = workspace
        self.size = size

    def checkout(self) -> GMRFWorkspace:
        return self.workspace

    def checkin(self, ws: GMRFWorkspace) -> None:
        pass

    def with_workspace(self, fn):
        return fn(self.workspace)

    def batch_evaluate(self, fn, batch_size: int | None = None, **theta_arrays):
        """fn(gmrf) at every θ (arrays of one leading length B): one batched
        evaluation per chunk of `batch_size` θs (all B when None), the chunks'
        results concatenated along the chain axis."""
        names = sorted(theta_arrays)
        stacked = [as_tensor(theta_arrays[k]) for k in names]
        B = stacked[0].shape[0]
        step = B if batch_size is None else batch_size
        parts = []
        for lo in range(0, B, step):
            g = self.workspace.evaluate(**{k: v[lo:lo + step] for k, v in zip(names, stacked)})
            parts.append(fn(g))
        return _concat(parts)


def make_workspace(
    model,
    obs_hessian: str | SparsePattern | None = "diag",
    solver: SolverSpec | None = None,
    **theta_ref,
) -> GMRFWorkspace:
    """A workspace whose pattern is the prior pattern ∪ the
    observation-Hessian pattern, so Newton iterations of
    `gaussian_approximation` never change sparsity (reference
    latent_model_integration.jl:116-134). The prior pattern is read from
    ``model.precision`` at θ_ref (every θ gives the same one).

    obs_hessian: "diag" (conditionally independent likelihoods), an explicit
    SparsePattern (e.g. AᵀA for linearly transformed observations), or None.
    """
    if not theta_ref:
        theta_ref = {h: 1.0 for h in getattr(model, "hyperparameters", ())}
    pat = model.precision(**theta_ref).pattern
    n = pat.shape[0]
    if obs_hessian == "diag":
        pat = union_patterns(pat, diag_pattern(n))
    elif isinstance(obs_hessian, SparsePattern):
        pat = union_patterns(pat, obs_hessian)
    spec = solver if solver is not None else SolverSpec()
    return GMRFWorkspace(model=model, pattern=pat, solver=spec.resolve(pat))


def make_workspace_pool(model, size: int = 1, **kw) -> WorkspacePool:
    return WorkspacePool(make_workspace(model, **kw), size=size)
