"""Wrapper of the gather-segment-sum kernel K5 (``csrc/segsum.cu``) and its
plain version.

A `SegPlan` is static host data: for each output row r a target ``t[r]``
(default r) and a segment of terms (CSR ``ptr``, or a fixed ``width`` for
every row), each term gathering ``x[xi[k]]`` and, optionally, ``y[yi[k]]``
and ``z[zi[k]]``. `gather_segsum` computes, per chain b,

    out[b, t[r]] (= or +=) alpha * Σ_k x[b, xi[k]] · y[b, yi[k]] · z[b, zi[k]]

With ``split``, row r's first split[r] terms and the rest are two sums added
in turn, (out + alpha Σ₁) + alpha Σ₂: a supernodal level's two ELL tiers in
one row, rounded as the reference's two scatter-adds round them.

The plan puts its rows of at least `BLOCK_TERMS` terms last, cut into
chunks of at most `CHUNK_TERMS` terms within one part, a block each in the
kernel; their sums accumulate in float64 and are rounded once per part, in
the kernel and the plain version alike. A shorter row takes a thread, which
sums it in the output's type in the plain version's order. The plan packs
its device tables into one argument block per device, so that a call
passes only its operands.

K5's second entry, `fct_init`, is the supernodal factorization's preamble
over an `InitPlan`: symmetrize, Jacobi-equilibrate and scatter onto the fill
pattern (``tpu_gmrf/solvers/supernodal.py:931``).

A CPU tensor takes the plain version (gather + ``index_add``); a CUDA
tensor launches K5 and raises if it cannot. ``gather_segsum.launches`` and
``fct_init.launches`` count the kernel launches. Targets must be unique
within one plan.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .tridiag import _fn, _on_cuda, _stream

__all__ = ["SegPlan", "InitPlan", "gather_segsum", "gather_segsum_plain", "fct_init", "fct_init_plain",
           "BLOCK_TERMS", "CHUNK_TERMS"]

# A row of at least BLOCK_TERMS terms takes blocks of K5 (csrc/segsum.cu), one per chunk of at most CHUNK_TERMS
# terms of one part, summing in float64; a shorter row takes a thread, which sums it in the plain version's order.
BLOCK_TERMS = 256
CHUNK_TERMS = 2048
GROUP = 8  # kGroup of the source: chains per thread

_TABLES = ("t", "ptr", "xi", "yi", "zi", "mid", "ck", "crow", "cptr", "cmid")


class _Pack(ctypes.Structure):
    """`Plan` of csrc/segsum.cu: the device tables, the chunks' scratch and the row runs."""

    _fields_ = [(k, ctypes.c_void_p) for k in _TABLES + ("part", "count")] + [
        (k, ctypes.c_int) for k in ("r_block", "rows", "chunks")]


class SegPlan:
    """Static gather-segment-sum plan over int32 host arrays."""

    def __init__(self, xi, *, ptr=None, width=None, t=None, yi=None, zi=None, n_rows=None, split=None):
        if (ptr is None) == (width is None):
            raise ValueError("SegPlan: give exactly one of ptr and width")
        # own copies: the tables may be read-only arrays of a pattern
        xi = np.array(xi, dtype=np.int32).ravel()
        yi = None if yi is None else np.array(yi, dtype=np.int32).ravel()
        zi = None if zi is None else np.array(zi, dtype=np.int32).ravel()
        t = None if t is None else np.array(t, dtype=np.int32).ravel()
        if ptr is None:
            width = int(width)
            rows = int(n_rows) if n_rows is not None else len(xi) // max(width, 1)
            if rows * width != len(xi):
                raise ValueError("SegPlan: fixed-width rows do not tile the terms")
            ptr = np.arange(rows + 1) * width
        ptr = np.array(ptr, dtype=np.int64).ravel()
        rows = len(ptr) - 1
        if ptr[0] != 0 or ptr[-1] != len(xi) or np.any(np.diff(ptr) < 0):
            raise ValueError("SegPlan: ptr must rise from 0 to the number of terms")
        if t is not None and len(t) != rows:
            raise ValueError("SegPlan: one target per row")
        if yi is not None and len(yi) != len(xi):
            raise ValueError("SegPlan: xi and yi differ in length")
        if zi is not None and (yi is None or len(zi) != len(xi)):
            raise ValueError("SegPlan: zi needs yi, of the same length as xi")
        if any(a is not None and len(a) and a.min() < 0 for a in (xi, yi, zi, t)):
            raise ValueError("SegPlan: negative index")
        counts = np.diff(ptr)
        if split is not None:
            split = np.array(split, dtype=np.int64).ravel()
            if len(split) != rows or np.any(split < 0) or np.any(split > counts):
                raise ValueError("SegPlan: split must count at most each row's terms")
        self.full = t is None  # writes rows 0 .. rows - 1: an output can be made for it
        long = counts >= BLOCK_TERMS
        if np.any(long[:-1] > long[1:]):  # the long rows last, each run in its given order
            order = np.argsort(long, kind="stable")
            t = (np.arange(rows, dtype=np.int32) if t is None else t)[order]
            counts, long = counts[order], long[order]
            start = np.concatenate([[0], np.cumsum(counts)])
            terms = np.repeat(ptr[:-1][order] - start[:-1], counts) + np.arange(len(xi))
            xi, yi, zi = (None if a is None else a[terms] for a in (xi, yi, zi))
            split = None if split is None else split[order]
            ptr = start
        self.xi, self.yi, self.zi, self.t, self.ptr = xi, yi, zi, t, ptr.astype(np.int32)
        self.mid = None if split is None else (ptr[:-1] + split).astype(np.int32)  # where a row's second part starts
        self.rows = rows
        self.r_block = int(np.sum(~long))  # the first row of the long run
        self._chunk()
        # the least row counts of x, y, z and the output (O(1) checks of a call)
        self.needs = tuple(0 if a is None or not len(a) else int(a.max()) + 1 for a in (xi, yi, zi)) + (
            rows if t is None else (int(t.max()) + 1 if rows else 0),)
        self._dev, self._packs = {}, {}

    def _chunk(self):
        """The long rows' chunks, at most CHUNK_TERMS terms each within one part
        (the kernel's `ck`, `crow`, `cptr`, `cmid`)."""
        ck, crow, cptr, cmid = [], [], [0], []
        for j, r in enumerate(range(self.r_block, self.rows)):
            a, e = int(self.ptr[r]), int(self.ptr[r + 1])
            m = e if self.mid is None else int(self.mid[r])
            ck.extend(range(a, m, CHUNK_TERMS))
            cmid.append(len(ck))
            ck.extend(range(m, e, CHUNK_TERMS))
            crow.extend([j] * (len(ck) - cptr[-1]))
            cptr.append(len(ck))
        self.chunks = len(ck)
        self.ck = np.array(ck + [int(self.ptr[-1])], dtype=np.int32)
        self.crow, self.cptr = np.array(crow, dtype=np.int32), np.array(cptr, dtype=np.int32)
        self.cmid = None if self.mid is None else np.array(cmid, dtype=np.int32)

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
            term_row = np.repeat(np.arange(self.rows), np.diff(self.ptr))
            long = self.chunks > 0
            d = {k: i32(getattr(self, k)) for k in _TABLES[:6]}
            d.update({k: i32(getattr(self, k)) if long else None for k in _TABLES[6:]})
            d.update(t_l=i64(self.t if self.t is not None else np.arange(self.rows)), xi_l=i64(self.xi),
                     yi_l=i64(self.yi), zi_l=i64(self.zi), term_row=i64(term_row))
            # the plain version's parts, the terms before and after each row's mid: the short rows' terms and
            # rows, then the long rows' terms and rows counted from r_block (None for all terms, or none)
            long_term = term_row >= self.r_block
            if self.mid is None and not long_term.any():
                d["parts"] = [(None, d["term_row"], None, None)]
            else:
                if self.mid is None:
                    part = [np.ones(len(self.xi), bool)]
                else:
                    first = np.arange(len(self.xi)) < self.mid[term_row]
                    part = [first, ~first]
                d["parts"] = [(i64(np.nonzero(f & ~long_term)[0]), i64(term_row[f & ~long_term]),
                               i64(np.nonzero(f & long_term)[0]), i64(term_row[f & long_term] - self.r_block))
                              for f in part]
            self._dev[key] = d
        return d

    def pack(self, index: int, groups: int) -> int:
        """Address of the kernel's argument block on CUDA device `index` (built
        once per device), its chunks' scratch sized for `groups` groups of
        GROUP chains."""
        got = self._packs.get(index)
        if got is None:
            d = self.tensors(torch.device("cuda", index))
            p = _Pack(*(None if d[k] is None else d[k].data_ptr() for k in _TABLES), None, None,
                      self.r_block, self.rows, self.chunks)
            got = self._packs[index] = [p, 0, None]  # the block, its scratch's groups, the scratch
        if self.chunks and got[1] < groups:
            dev = torch.device("cuda", index)
            part = torch.empty(groups, self.chunks * GROUP, dtype=torch.float64, device=dev)
            count = torch.zeros(groups, self.rows - self.r_block, dtype=torch.int32, device=dev)
            got[0].part, got[0].count = part.data_ptr(), count.data_ptr()
            got[1:] = groups, (part, count)
        return ctypes.addressof(got[0])


def _stride(a: torch.Tensor, B: int, need: int) -> int:
    """Chain stride of a (m,) or (B, m) operand with m >= need (0: shared by the chains)."""
    if a.ndim == 1 and a.size(0) >= need:
        return 0
    if a.ndim == 2 and a.size(0) == B and a.size(1) >= need:
        return a.size(1)
    raise ValueError(f"gather_segsum: expected (m,) or ({B}, m) with m >= {need}, got {tuple(a.shape)}")


def _new_out(plan: SegPlan, x, y, accumulate: bool):
    """A fresh (B, rows) output, B from x or y; only for plans that write every row."""
    if accumulate or not plan.full:
        raise ValueError("gather_segsum: accumulating or targeted plans need an output")
    B = x.shape[0] if x.ndim == 2 else (y.shape[0] if y is not None and y.ndim == 2 else 1)
    return x.new_empty(B, plan.rows)


def _check_factors(plan: SegPlan, y, z):
    if (y is None) != (plan.yi is None) or (z is None) != (plan.zi is None):
        raise ValueError("gather_segsum: give y (z) exactly when the plan has yi (zi)")


def gather_segsum_plain(plan: SegPlan, x, y=None, out=None, alpha: float = 1.0, accumulate: bool = False,
                        z=None):
    """Same as `gather_segsum`, in plain torch (gather, ``index_add``; the long rows in float64)."""
    _check_factors(plan, y, z)
    d = plan.tensors(x.device)
    if out is None:
        out = _new_out(plan, x, y, accumulate)
    terms = x[..., d["xi_l"]]
    if y is not None:
        terms = terms * y[..., d["yi_l"]]
    if z is not None:
        terms = terms * z[..., d["zi_l"]]
    B = out.shape[0]
    terms = terms.expand(B, -1)
    v = out[:, d["t_l"]] if accumulate else out.new_zeros(B, plan.rows)
    for ks, rs, kl, rl in d["parts"]:  # (out + alpha Σ₁) + alpha Σ₂
        s = out.new_zeros(B, plan.rows).index_add_(1, rs, terms if ks is None else terms[:, ks])
        if kl is not None and len(kl):  # the long rows' sums in float64, rounded once
            s[:, plan.r_block:] = terms.new_zeros(B, plan.rows - plan.r_block, dtype=torch.float64).index_add_(
                1, rl, terms[:, kl].to(torch.float64))
        v = v + alpha * s
    out[:, d["t_l"]] = v
    return out


def gather_segsum(plan: SegPlan, x, y=None, out=None, alpha: float = 1.0, accumulate: bool = False,
                  z=None):
    """K5: out[b, t[r]] (=|+=) alpha · Σ_k x[b, xi[k]] · y[b, yi[k]] · z[b, zi[k]].

    x, y, z are (m,) (shared by all chains) or (B, m); y and z are given
    exactly when the plan has yi and zi. out is (B, O), updated in place and
    returned, or, when None, a new (B, rows) tensor. The operands' and the
    output's lengths are checked against the plan's largest indices (O(1)
    per call), so the kernel reads and writes within them."""
    _check_factors(plan, y, z)
    if out is None:
        out = _new_out(plan, x, y, accumulate)
    needs = plan.needs
    if out.ndim != 2 or out.size(1) < needs[3]:
        raise ValueError(f"gather_segsum: out must be (B, O >= {needs[3]}), got {tuple(out.shape)}")
    B = out.size(0)
    xs = _stride(x, B, needs[0])
    ys = 0 if y is None else _stride(y, B, needs[1])
    zs = 0 if z is None else _stride(z, B, needs[2])
    if not _on_cuda("gather_segsum", *((out, x) if y is None else (out, x, y) if z is None else (out, x, y, z))):
        return gather_segsum_plain(plan, x, y, out, alpha, accumulate, z)
    code = _fn("tg_gather_segsum", out.dtype)(
        plan.pack(out.get_device(), -(-B // GROUP)), out.data_ptr(), out.size(1), x.data_ptr(), xs,
        None if y is None else y.data_ptr(), ys, None if z is None else z.data_ptr(), zs,
        float(alpha), int(accumulate), B, _stream(out),
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
