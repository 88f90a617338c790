"""Block-diagonal model composition with hyperparameter suffixes.

Counterpart of ``tpu_gmrf.models.combined``: components stack
block-diagonally; hyperparameters get `_modelname[_k]` suffixes
(`tau_besag`, `tau_iid_2`, ...); constraints embed into the stacked space;
components are reached by name (`component`, or as attributes). The blocks'
data take the dtype of the θ tensors given (a component without
hyperparameters, such as `FixedEffectsModel`, has none of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.matrix import SparseMatrix, sp_block_diag
from .base import LatentModel, stack_constraints

__all__ = ["CombinedModel"]


def _component_names(components):
    names = []
    counts: dict = {}
    for comp in components:
        base = comp.name
        counts[base] = counts.get(base, 0) + 1
        names.append(base if counts[base] == 1 else f"{base}_{counts[base]}")
    return names


def _split_theta(model, theta):
    per_comp = []
    for comp, cname in zip(model.components, model.component_names):
        sub = {}
        for p in comp.hyperparameters:
            key = f"{p}_{cname}"
            if key not in theta:
                raise ValueError(f"missing required hyperparameter: {key}")
            sub[p] = theta[key]
        per_comp.append(sub)
    return per_comp


def _theta_dtype(per_comp):
    """The promoted dtype of the θ tensors given, None if none is a tensor."""
    dts = [v.dtype for sub in per_comp for v in sub.values() if torch.is_tensor(v)]
    if not dts:
        return None
    out = dts[0]
    for d in dts[1:]:
        out = torch.promote_types(out, d)
    return out


def _cast(mats, dtype):
    return mats if dtype is None else [SparseMatrix(m.data.to(dtype), m.pattern) for m in mats]


class CombinedModel(LatentModel):
    name = "combined"

    def __init__(self, *components, solver=None):
        if len(components) == 1 and isinstance(components[0], (list, tuple)):
            components = tuple(components[0])
        if not components:
            raise ValueError("CombinedModel needs at least one component")
        self.components = components
        self.component_names = _component_names(components)
        self.sizes = [c.n for c in components]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return int(self.offsets[-1])

    @property
    def hyperparameters(self):
        out = []
        for comp, cname in zip(self.components, self.component_names):
            out.extend(f"{p}_{cname}" for p in comp.hyperparameters)
        return tuple(out)

    def precision(self, **theta):
        per_comp = _split_theta(self, theta)
        mats = [c.precision(**sub) for c, sub in zip(self.components, per_comp)]
        return sp_block_diag(_cast(mats, _theta_dtype(per_comp)))

    def mean(self, **theta):
        per_comp = _split_theta(self, theta)
        means = [c.mean(**sub) for c, sub in zip(self.components, per_comp)]
        dtype = _theta_dtype(per_comp)
        means = [m if dtype is None else m.to(dtype) for m in means]
        batch = torch.broadcast_shapes(*(m.shape[:-1] for m in means))
        return torch.cat([m.expand(batch + m.shape[-1:]) for m in means], -1)

    def constraints(self):
        parts = []
        for i, comp in enumerate(self.components):
            cc = comp.constraints()
            if cc is None:
                continue
            A, e = cc
            A_full = np.zeros((A.shape[0], self.n))
            A_full[:, self.offsets[i] : self.offsets[i + 1]] = A
            parts.append((A_full, e))
        return stack_constraints(*parts)

    def component(self, name: str):
        for comp, cname in zip(self.components, self.component_names):
            if cname == name:
                return comp
        raise KeyError(
            f"no component named {name!r}; available: {self.component_names}"
        )

    def __getattr__(self, name):
        if name.startswith("_") or name in ("components", "component_names"):
            raise AttributeError(name)
        try:
            return self.component(name)
        except KeyError:
            raise AttributeError(name) from None
