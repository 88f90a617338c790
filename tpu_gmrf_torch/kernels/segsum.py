"""Wrapper of the gather-segment-sum kernel K5 (``csrc/segsum.cu``) and its
plain version.

A `SegPlan` is static host data: for each output row r a target ``t[r]``
(default r) and a segment of terms (CSR ``ptr`` or a fixed ``width``), each
term gathering ``x[xi[k]]`` and, optionally, ``y[yi[k]]`` and ``z[zi[k]]``.
`gather_segsum` computes, per chain b,

    out[b, t[r]] (= or +=) alpha * Σ_k x[b, xi[k]] · y[b, yi[k]] · z[b, zi[k]]

K5's second entry, `fct_init`, is the supernodal factorization's preamble
over an `InitPlan`: symmetrize, Jacobi-equilibrate and scatter onto the fill
pattern (``tpu_gmrf/solvers/supernodal.py:931``).

A CPU tensor takes the plain version (gather + ``index_add``); a CUDA
tensor launches K5 and raises if it cannot. ``gather_segsum.launches`` and
``fct_init.launches`` count the kernel launches. Targets must be unique
within one plan.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .tridiag import _fn, _on_cuda, _stream

__all__ = ["SegPlan", "InitPlan", "gather_segsum", "gather_segsum_plain", "fct_init", "fct_init_plain"]


class SegPlan:
    """Static gather-segment-sum plan over int32 host arrays."""

    def __init__(self, xi, *, ptr=None, width=None, t=None, yi=None, zi=None, n_rows=None):
        if (ptr is None) == (width is None):
            raise ValueError("SegPlan: give exactly one of ptr and width")
        # own copies: the tables may be read-only arrays of a pattern
        self.xi = np.array(xi, dtype=np.int32).ravel()
        self.yi = None if yi is None else np.array(yi, dtype=np.int32).ravel()
        self.zi = None if zi is None else np.array(zi, dtype=np.int32).ravel()
        self.t = None if t is None else np.array(t, dtype=np.int32).ravel()
        if ptr is not None:
            self.ptr = np.array(ptr, dtype=np.int32).ravel()
            self.width = 0
            self.rows = len(self.ptr) - 1
        else:
            self.ptr = None
            self.width = int(width)
            self.rows = int(n_rows) if n_rows is not None else len(self.xi) // max(self.width, 1)
            if self.rows * self.width != len(self.xi):
                raise ValueError("SegPlan: fixed-width rows do not tile the terms")
        if self.t is not None and len(self.t) != self.rows:
            raise ValueError("SegPlan: one target per row")
        if self.yi is not None and len(self.yi) != len(self.xi):
            raise ValueError("SegPlan: xi and yi differ in length")
        if self.zi is not None and (self.yi is None or len(self.zi) != len(self.xi)):
            raise ValueError("SegPlan: zi needs yi, of the same length as xi")
        self._dev = {}

    @classmethod
    def grouped(cls, rows, xi, n_rows, yi=None, t=None):
        """Plan whose row r sums the terms k with rows[k] == r (stable order)."""
        rows = np.asarray(rows, dtype=np.int64)
        order = np.argsort(rows, kind="stable")
        ptr = np.zeros(n_rows + 1, np.int64)
        np.add.at(ptr, rows + 1, 1)
        ptr = np.cumsum(ptr)
        return cls(np.asarray(xi)[order], ptr=ptr, t=t,
                   yi=None if yi is None else np.asarray(yi)[order])

    def tensors(self, device) -> dict:
        """Device copies (int32 for the kernel, int64 for the plain version), cached."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            i32 = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.int32, device=device)
            i64 = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.long, device=device)
            counts = np.diff(self.ptr) if self.ptr is not None else np.full(self.rows, self.width)
            d = dict(
                t=i32(self.t), ptr=i32(self.ptr), xi=i32(self.xi), yi=i32(self.yi), zi=i32(self.zi),
                t_l=i64(self.t if self.t is not None else np.arange(self.rows)),
                xi_l=i64(self.xi), yi_l=i64(self.yi), zi_l=i64(self.zi),
                term_row=i64(np.repeat(np.arange(self.rows), counts)),
            )
            self._dev[key] = d
        return d


def _rows2(a: torch.Tensor | None, B: int):
    """(tensor as (B or 1, m), chain stride) for a (m,) or (B, m) tensor."""
    if a is None:
        return None, 0
    if a.ndim == 1:
        return a, 0
    if a.ndim != 2 or a.shape[0] != B:
        raise ValueError(f"gather_segsum: expected (m,) or ({B}, m), got {tuple(a.shape)}")
    return a, a.shape[1]


def _new_out(plan: SegPlan, x, y, accumulate: bool):
    """A fresh (B, rows) output, B from x or y; only for plans that write every row."""
    if accumulate or plan.t is not None:
        raise ValueError("gather_segsum: accumulating or targeted plans need an output")
    B = x.shape[0] if x.ndim == 2 else (y.shape[0] if y is not None and y.ndim == 2 else 1)
    return x.new_empty(B, plan.rows)


def _check_factors(plan: SegPlan, y, z):
    if (y is None) != (plan.yi is None) or (z is None) != (plan.zi is None):
        raise ValueError("gather_segsum: give y (z) exactly when the plan has yi (zi)")


def gather_segsum_plain(plan: SegPlan, x, y=None, out=None, alpha: float = 1.0, accumulate: bool = False,
                        z=None):
    """Same as `gather_segsum`, in plain torch (gather, ``index_add``)."""
    _check_factors(plan, y, z)
    d = plan.tensors(x.device)
    if out is None:
        out = _new_out(plan, x, y, accumulate)
    terms = x[..., d["xi_l"]]
    if y is not None:
        terms = terms * y[..., d["yi_l"]]
    if z is not None:
        terms = terms * z[..., d["zi_l"]]
    terms = terms.expand(out.shape[0], -1)
    s = out.new_zeros(out.shape[0], plan.rows).index_add_(1, d["term_row"], terms)
    if accumulate:
        out[:, d["t_l"]] += alpha * s
    else:
        out[:, d["t_l"]] = alpha * s
    return out


def gather_segsum(plan: SegPlan, x, y=None, out=None, alpha: float = 1.0, accumulate: bool = False,
                  z=None):
    """K5: out[b, t[r]] (=|+=) alpha · Σ_k x[b, xi[k]] · y[b, yi[k]] · z[b, zi[k]].

    x, y, z are (m,) (shared by all chains) or (B, m); y and z are given
    exactly when the plan has yi and zi. out is (B, O), updated in place and
    returned, or, when None, a new (B, rows) tensor. Indices are not
    bounds-checked on the card: a plan is built against its arrays."""
    _check_factors(plan, y, z)
    if out is None:
        out = _new_out(plan, x, y, accumulate)
    if out.ndim != 2:
        raise ValueError(f"gather_segsum: out must be (B, O), got {tuple(out.shape)}")
    tensors = [out, x] + [a for a in (y, z) if a is not None]
    if not _on_cuda("gather_segsum", *tensors):
        return gather_segsum_plain(plan, x, y, out, alpha, accumulate, z)
    B = out.shape[0]
    x, xs = _rows2(x, B)
    y, ys = _rows2(y, B)
    z, zs = _rows2(z, B)
    d = plan.tensors(out.device)
    ptr = lambda a: None if a is None else a.data_ptr()
    code = _fn("tg_gather_segsum", out.dtype)(
        out.data_ptr(), out.shape[1], ptr(d["t"]), ptr(d["ptr"]), plan.width, d["xi"].data_ptr(),
        x.data_ptr(), xs, ptr(d["yi"]), ptr(y), ys, ptr(d["zi"]), ptr(z), zs, float(alpha),
        int(accumulate), plan.rows, B, _stream(out),
    )
    build.check(code, "gather_segsum")
    gather_segsum.launches += 1
    return out


gather_segsum.launches = 0


# ---- K5's second entry: the supernodal factorization's preamble ---------------------


class InitPlan:
    """Static tables of `fct_init`: a symmetric pattern's transpose
    permutation, diagonal positions, rows and cols, and the unique scatter
    ``vals[dst[k]] = scaled[src[k]]`` of its lower entries onto the fill
    pattern (the plan's ``a_src``/``a_dst``)."""

    _KEYS = ("tperm", "diag", "rows", "cols", "src", "dst")

    def __init__(self, tperm, diag, rows, cols, src, dst):
        for k, a in zip(self._KEYS, (tperm, diag, rows, cols, src, dst)):
            setattr(self, k, np.array(a, dtype=np.int32).ravel())
        self.n, self.nnz, self.m = len(self.diag), len(self.tperm), len(self.src)
        if len(self.dst) != self.m or len(self.rows) != self.nnz or len(self.cols) != self.nnz:
            raise ValueError("InitPlan: table lengths disagree")
        self._dev = {}

    def tensors(self, device) -> dict:
        """Device copies (int32 for the kernel, int64 ``<key>_l`` for the plain version), cached."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            d = {}
            for k in self._KEYS:
                a = getattr(self, k)
                d[k] = torch.as_tensor(a, dtype=torch.int32, device=device)
                d[k + "_l"] = torch.as_tensor(a, dtype=torch.long, device=device)
            self._dev[key] = d
        return d


def fct_init_plain(plan: InitPlan, data, vals, s, nls):
    """Same as `fct_init`, in plain torch (``_fct_init`` of the reference)."""
    d = plan.tensors(data.device)
    sym = 0.5 * (data + data[:, d["tperm_l"]])
    dg = sym[:, d["diag_l"]]
    one = torch.ones_like(dg)
    sv = torch.where(dg > 0, torch.rsqrt(torch.where(dg > 0, dg, one)), one)
    s.copy_(sv)
    nls.copy_(-torch.log(sv))
    scaled = sym * sv[:, d["rows_l"]] * sv[:, d["cols_l"]]
    vals[:, d["dst_l"]] = scaled[:, d["src_l"]]


def fct_init(plan: InitPlan, data, vals, s, nls):
    """K5 `fct_init`: from data (B, nnz) of a symmetric pattern write the
    Jacobi scaling s (B, n), nls = -log s (B, n, any row stride) and the
    scaled lower entries of the symmetrized matrix into their positions of
    vals (B, nnzL+1); vals' other entries are left as they are."""
    if data.ndim != 2 or data.shape[1] != plan.nnz or s.shape != (data.shape[0], plan.n) \
            or nls.shape != s.shape or vals.ndim != 2 or vals.shape[0] != data.shape[0]:
        raise ValueError("fct_init: shapes do not match the plan")
    if not _on_cuda("fct_init", vals, data, s):
        return fct_init_plain(plan, data, vals, s, nls)
    if nls.device != vals.device or nls.dtype != vals.dtype or nls.stride(1) != 1:
        raise ValueError("fct_init: nls must be rows of unit stride on the values' device and dtype")
    t = plan.tensors(vals.device)
    code = _fn("tg_fct_init", vals.dtype)(
        vals.data_ptr(), vals.shape[1], s.data_ptr(), nls.data_ptr(), nls.stride(0), data.data_ptr(),
        data.shape[1], *(t[k].data_ptr() for k in InitPlan._KEYS), plan.n, plan.m, data.shape[0],
        _stream(vals),
    )
    build.check(code, "fct_init")
    fct_init.launches += 1


fct_init.launches = 0
