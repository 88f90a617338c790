"""Formula terms: placeholder functors mapping data columns to (design
block, latent model) pairs.

Counterpart of ``tpu_gmrf.formula.terms`` (reference
src/formula/constructors.jl:1-433 and
ext/GaussianMarkovRandomFieldsFormula/{terms,build}.jl). Codes and
covariates are read on the host (a tensor column is copied to NumPy);
design blocks are float64 SparseMatrix on the default device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..models import ARModel, BYM2Model, BesagModel, IIDModel, RWModel
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern

__all__ = [
    "Col",
    "Term",
    "Intercept",
    "Fixed",
    "IID",
    "RandomWalk",
    "RW1",
    "RW2",
    "AR1",
    "AR",
    "Besag",
    "BYM2",
    "Matern",
    "Separable",
    "TermList",
]


def _colname(c):
    return c.name if isinstance(c, Col) else c


def host(values) -> np.ndarray:
    """A data column as a NumPy array; a tensor, wherever it lies, is copied to the host."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _ones_on(pattern: SparsePattern) -> SparseMatrix:
    return SparseMatrix(as_tensor(np.ones(pattern.nnz)), pattern)


def indicator_matrix(codes: np.ndarray, n_levels: int) -> SparseMatrix:
    """The (m, n_levels) 0/1 matrix with a one at (i, codes[i])."""
    m = len(codes)
    return _ones_on(SparsePattern(np.arange(m), np.asarray(codes, dtype=np.int64), (m, n_levels)))


def _factor_codes(values):
    """(codes, levels) with levels sorted unique."""
    levels, codes = np.unique(host(values), return_inverse=True)
    return codes.reshape(-1), levels


class Col:
    """Bare column reference produced by the string-formula namespace."""

    def __init__(self, name):
        self.name = name

    def __add__(self, other):
        return TermList([Fixed(self.name)]) + other

    def __radd__(self, other):
        return TermList._coerce(other) + Fixed(self.name)

    def __repr__(self):
        return f"Col({self.name})"


class Term:
    """Base: build(data) -> (A_block: SparseMatrix, model | None, levels)."""

    def __add__(self, other):
        return TermList([self]) + other

    def __radd__(self, other):
        return TermList._coerce(other) + self

    def build(self, data):
        raise NotImplementedError


class TermList:
    def __init__(self, terms):
        self.terms = list(terms)

    @staticmethod
    def _coerce(x):
        if isinstance(x, TermList):
            return x
        if isinstance(x, Term):
            return TermList([x])
        if isinstance(x, Col):
            return TermList([Fixed(x.name)])
        if x == 1:
            return TermList([Intercept()])
        if x == 0:
            return TermList([])
        raise TypeError(f"cannot use {x!r} in a formula")

    def __add__(self, other):
        other = TermList._coerce(other)
        return TermList(self.terms + other.terms)

    __radd__ = __add__


class Intercept(Term):
    is_fixed = True

    def fixed_cols(self, data):
        n = len(next(iter(data.values())))
        return np.ones((n, 1))


class Fixed(Term):
    is_fixed = True

    def __init__(self, col):
        self.col = _colname(col)

    def fixed_cols(self, data):
        return host(data[self.col]).astype(np.float64).reshape(-1, 1)


class _FactorTerm(Term):
    is_fixed = False

    def __init__(self, col):
        self.col = _colname(col)

    def _codes(self, data):
        return _factor_codes(data[self.col])


class IID(_FactorTerm):
    def __init__(self, col, constraint=None):
        super().__init__(col)
        self.constraint = constraint

    def build(self, data):
        codes, levels = self._codes(data)
        return (
            indicator_matrix(codes, len(levels)),
            IIDModel(len(levels), constraint=self.constraint, levels=levels),
            levels,
        )


class RandomWalk(_FactorTerm):
    def __init__(self, col, order: int = 1, scale_model: bool = False):
        super().__init__(col)
        self.order = order
        self.scale_model = scale_model

    def build(self, data):
        codes, levels = self._codes(data)
        return (
            indicator_matrix(codes, len(levels)),
            RWModel(len(levels), order=self.order, scale_model=self.scale_model),
            levels,
        )


def RW1(col, **kw):
    return RandomWalk(col, order=1, **kw)


def RW2(col, **kw):
    return RandomWalk(col, order=2, **kw)


class AR(_FactorTerm):
    def __init__(self, col, order: int = 1):
        super().__init__(col)
        self.order = order

    def build(self, data):
        codes, levels = self._codes(data)
        return (
            indicator_matrix(codes, len(levels)),
            ARModel(len(levels), order=self.order),
            levels,
        )


def AR1(col):
    return AR(col, order=1)


class Besag(_FactorTerm):
    def __init__(self, col, W, **kw):
        super().__init__(col)
        self.W = W
        self.kw = kw

    def build(self, data):
        codes = host(data[self.col]).astype(np.int64)
        model = BesagModel(self.W, **self.kw)
        return indicator_matrix(codes, model.n), model, np.arange(model.n)


class BYM2(_FactorTerm):
    def __init__(self, col, W, **kw):
        super().__init__(col)
        self.W = W
        self.kw = kw

    def build(self, data):
        codes = host(data[self.col]).astype(np.int64)
        model = BYM2Model(self.W, **self.kw)
        half = model.n // 2
        # predictor = u*_i + v_i: [indicator | indicator] over the 2n stack
        m = len(codes)
        rows = np.concatenate([np.arange(m), np.arange(m)])
        cols = np.concatenate([codes, codes + half])
        return _ones_on(SparsePattern(rows, cols, (m, model.n))), model, np.arange(half)


class Matern(Term):
    """Matern(['x', 'y'], smoothness=1): continuous spatial field evaluated
    at observation coordinates."""

    is_fixed = False

    def __init__(self, cols, smoothness: int = 1, element_size=None, **kw):
        self.cols = [_colname(c) for c in (cols if isinstance(cols, (list, tuple)) else [cols])]
        self.smoothness = smoothness
        self.element_size = element_size
        self.kw = kw

    def points(self, data) -> np.ndarray:
        return np.stack([host(data[c]).astype(np.float64) for c in self.cols], axis=1)

    def build(self, data):
        from ..fem import MaternModel

        pts = self.points(data)
        model = MaternModel(pts, smoothness=self.smoothness, element_size=self.element_size, **self.kw)
        return model.disc.evaluation_matrix(pts), model, pts


class Separable(Term):
    """Khatri-Rao (row-wise Kronecker) of factor terms — space-time
    interactions. Components must be factor terms (IID/RW/AR/Besag)."""

    is_fixed = False

    def __init__(self, *components):
        self.components = components

    def build(self, data):
        from ..models import SeparableModel

        built = [c.build(data) for c in self.components]
        sep = SeparableModel(*(b[1] for b in built))
        # row-wise kron of indicator blocks (each row one-hot → product index)
        A = built[0][0]
        for b in built[1:]:
            A = _khatri_rao_indicator(A, b[0])
        return A, sep, None


def _khatri_rao_indicator(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """Row-wise Kronecker for row-sparse design blocks: in each row r, every
    pair (A's entry i, B's entry j), i outer and j inner, at column
    A.col(i)·B.ncols + B.col(j), by index arithmetic over the CSR rows."""
    pa, pb = A.pattern, B.pattern
    m = A.shape[0]
    per_row = np.diff(pb.indptr).astype(np.int64)
    k = per_row[pa.rows]  # B's entries in each A entry's row
    va = np.repeat(np.arange(pa.nnz), k)
    vb = np.repeat(pb.indptr[pa.rows].astype(np.int64), k) + (np.arange(len(va)) - np.repeat(np.cumsum(k) - k, k))
    cols = pa.cols[va].astype(np.int64) * B.shape[1] + pb.cols[vb]
    pat = SparsePattern(pa.rows[va], cols, (m, A.shape[1] * B.shape[1]))
    dev = A.data.device
    data = A.data[..., torch.as_tensor(va, device=dev)] * B.data[..., torch.as_tensor(vb, device=dev)]
    return SparseMatrix(data[..., torch.as_tensor(pat.sort_order, device=dev)], pat)
