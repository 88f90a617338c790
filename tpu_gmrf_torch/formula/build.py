"""Formula model builder.

Counterpart of ``tpu_gmrf.formula.build`` (reference
ext/GaussianMarkovRandomFieldsFormula/build.jl:216-330):
`build_formula_components(formula, data; family, trials, exposure)` returns
`(A, y, obs_model, combined_model, hyperparameters, meta)`: random-effect
blocks first, then one FixedEffectsModel for all fixed columns (ridge
λ=1e-6); the observation side is `ExponentialFamily(family)` lifted by the
stacked design through `LinearlyTransformedObservationModel`.

Accepts either a list of `Term` objects or an R-style string formula
("y ~ 1 + x + IID(g) + Besag(region, W)") evaluated in a namespace of term
constructors with bare data columns bound as `Col` references (extra
objects like adjacency matrices come from `context`). Data columns may be
NumPy arrays or tensors: codes and covariates are read on the host, the
response and the trials keep a tensor's device, and an exposure is taken
in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import as_tensor
from ..models import CombinedModel, FixedEffectsModel
from ..observations import (
    BinomialObservations,
    ExponentialFamily,
    LinearlyTransformedObservationModel,
    NegativeBinomialObservations,
    PoissonObservations,
)
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from . import terms as T

__all__ = ["build_formula_components", "FormulaComponents", "sp_hstack", "predict_cols"]


def sp_hstack(blocks) -> SparseMatrix:
    """[B₁ | B₂ | …] of blocks with one row count, on the first block's device."""
    m = blocks[0].shape[0]
    rows, cols = [], []
    off = 0
    for b in blocks:
        if b.shape[0] != m:
            raise ValueError("row-count mismatch in hstack")
        rows.append(b.pattern.rows.astype(np.int64))
        cols.append(b.pattern.cols.astype(np.int64) + off)
        off += b.shape[1]
    pat = SparsePattern(np.concatenate(rows), np.concatenate(cols), (m, off))
    dev = blocks[0].data.device
    data = torch.cat([b.data.to(dev) for b in blocks], dim=-1)
    return SparseMatrix(data[..., torch.as_tensor(pat.sort_order, device=dev)], pat)


@dataclasses.dataclass
class FormulaComponents:
    A: SparseMatrix
    y: Any
    obs_model: LinearlyTransformedObservationModel
    combined_model: CombinedModel
    hyperparameters: tuple
    meta: dict
    terms: list


def _parse_string_formula(formula: str, data, context):
    lhs, rhs = formula.split("~")
    lhs = lhs.strip()
    namespace = {
        "IID": T.IID,
        "RandomWalk": T.RandomWalk,
        "RW1": T.RW1,
        "RW2": T.RW2,
        "AR1": T.AR1,
        "AR": T.AR,
        "Besag": T.Besag,
        "BYM2": T.BYM2,
        "Matern": T.Matern,
        "Separable": T.Separable,
        "Fixed": T.Fixed,
        "Intercept": T.Intercept,
    }
    if context:
        namespace.update(context)
    for k in data:
        namespace.setdefault(k, T.Col(k))
    result = eval(rhs, {"__builtins__": {}}, namespace)  # noqa: S307 — restricted DSL eval
    return lhs, T.TermList._coerce(result).terms


def _column(values):
    """A response or trials column: a tensor as it is, anything else as a NumPy array."""
    return values if isinstance(values, torch.Tensor) else np.asarray(values)


def _exposure(values):
    """An exposure column in float64 (a float32 one would round log E), a tensor on its own device."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.float64)
    return np.asarray(values, dtype=np.float64)


def _fixed_block(X: np.ndarray) -> SparseMatrix:
    """The dense (m, p) covariate block as a SparseMatrix with every entry stored."""
    rows, cols = np.nonzero(np.ones_like(X, dtype=bool))
    pat = SparsePattern(rows, cols, X.shape)
    return SparseMatrix(as_tensor(np.ascontiguousarray(X, dtype=np.float64).ravel()[pat.sort_order]), pat)


def build_formula_components(
    formula,
    data,
    family: str = "normal",
    trials=None,
    exposure=None,
    fixed_prior: float = 1e-6,
    context: dict | None = None,
) -> FormulaComponents:
    if isinstance(formula, str):
        response, term_list = _parse_string_formula(formula, data, context or {})
        y = _column(data[response])
    else:
        response, term_list = None, list(formula)
        y = _column(data["y"]) if "y" in data else None

    fam = family.lower()
    if fam == "binomial":
        if trials is None:
            raise ValueError("family='binomial' requires trials column name")
        y = BinomialObservations(as_tensor(y), as_tensor(_column(data[trials])))
    elif fam == "poisson":
        expo = None if exposure is None else _exposure(data[exposure])
        y = PoissonObservations.create(y, exposure=expo)
    elif fam in ("negativebinomial", "negbin"):
        expo = None if exposure is None else _exposure(data[exposure])
        y = NegativeBinomialObservations.create(y, exposure=expo)

    random_terms = [t for t in term_list if not getattr(t, "is_fixed", False)]
    fixed_terms = [t for t in term_list if getattr(t, "is_fixed", False)]

    A_blocks, models, built_terms = [], [], []
    for t in random_terms:
        A_i, model, levels = t.build(data)
        A_blocks.append(A_i)
        models.append(model)
        built_terms.append((t, levels))

    n_fixed = 0
    if fixed_terms:
        X = np.hstack([t.fixed_cols(data) for t in fixed_terms])
        n_fixed = X.shape[1]
        A_blocks.append(_fixed_block(X))
        models.append(FixedEffectsModel(n_fixed, lam=fixed_prior))

    if not models:
        raise ValueError("no terms found on the formula RHS")

    A = sp_hstack(A_blocks)
    combined = CombinedModel(*models)
    obs_model = LinearlyTransformedObservationModel(ExponentialFamily(fam), A)
    if A.shape[1] != combined.n:
        raise ValueError(
            f"design columns ({A.shape[1]}) do not match latent dimension ({combined.n})"
        )
    meta = {
        "n_random": len(random_terms),
        "n_fixed": n_fixed,
        "term_sizes": [b.shape[1] for b in A_blocks],
        "fixed_terms": fixed_terms,
    }
    return FormulaComponents(
        A=A,
        y=y,
        obs_model=obs_model,
        combined_model=combined,
        hyperparameters=combined.hyperparameters,
        meta=meta,
        terms=built_terms,
    )


def _level_codes(values, levels) -> np.ndarray:
    """The position of each value among the fitted (sorted) levels; an unseen value raises KeyError."""
    values = T.host(values)
    idx = np.clip(np.searchsorted(levels, values), 0, max(len(levels) - 1, 0))
    unseen = levels[idx] != values
    if unseen.any():
        raise KeyError(values[unseen][0])
    return idx.astype(np.int64)


def predict_cols(components: FormulaComponents, newdata) -> SparseMatrix:
    """Out-of-sample design matrix for the random terms, matching the fitted
    latent layout (reference `predict_cols`). Fixed terms are re-evaluated
    from `newdata` columns."""
    blocks = []
    for t, levels in components.terms:
        if isinstance(t, T.Matern):
            # reuse the FITTED mesh
            model = [
                m
                for m in components.combined_model.components
                if getattr(m, "name", "") == "matern"
            ][0]
            blocks.append(model.disc.evaluation_matrix(t.points(newdata)))
        elif isinstance(t, T._FactorTerm):
            if isinstance(t, (T.Besag, T.BYM2)):
                codes = T.host(newdata[t.col]).astype(np.int64)
            else:
                codes = _level_codes(newdata[t.col], levels)
            blocks.append(T.indicator_matrix(codes, len(levels)))
        else:
            raise TypeError(f"predict_cols: unsupported term {type(t)}")
    n_fixed = components.meta["n_fixed"]
    if n_fixed:
        # fixed terms re-evaluate their covariate columns from newdata,
        # matching the fitted latent layout (reference
        # ext/GaussianMarkovRandomFieldsFormula/build.jl:216-330)
        X = np.hstack([t.fixed_cols(newdata) for t in components.meta["fixed_terms"]])
        if X.shape[1] != n_fixed:
            raise ValueError(f"newdata produced {X.shape[1]} fixed columns; fit had {n_fixed}")
        blocks.append(_fixed_block(X))
    return sp_hstack(blocks)
