"""Supernodal sparse Cholesky backend for general patterns, batched over chains.

Counterpart of ``tpu_gmrf.solvers.supernodal``: the general sparse Cholesky
and block-Takahashi selected inversion that plays CHOLMOD's role in the
reference library.

* **Host symbolic, once per pattern.** ``supernodal_plan`` and its helpers
  are the reference's NumPy code, copied verbatim (fill-reducing ordering by
  the native core in ``tpu_gmrf_torch.native``, etree, supernodes, relaxed
  amalgamation, the two-segment level schedule, the ELL reduction tables),
  so a plan equals the reference's table by table. Plans of n >= 50,000
  are also kept on disk when ``TPU_GMRF_PLAN_CACHE`` names a directory:
  one ``np.savez`` file per (pattern, width, ordering, format version),
  loaded with ``allow_pickle=False``; a file that is missing, unreadable or
  of another version is rebuilt, not trusted.
* **Device numeric, per value vector.** The level schedule is a host loop
  over levels. Each level's class batches are launches of hand-written
  kernels over all chains: K6 `sn_panel` (factor; one launch per level and
  path), K7 `sn_trsv` (solves; one launch per level), K8
  `sn_takahashi_prep` and `sn_takahashi` (selected inverse: the Σ-free half
  once per class shape, then the Σ-dependent products per class batch); the
  Schur and forward-solve reductions (one ragged launch per level each: a
  row per target), the permutation, logdet and selected-inverse
  gathers (with the Jacobi scaling undone) are K5 `gather_segsum`
  launches, and the preamble (symmetrize, equilibrate, scatter onto the
  fill pattern) is K5's `fct_init` entry (``tpu_gmrf_torch.kernels``). A class with no supernode on a level
  launches nothing. The plan's index tables go to the device once per
  (plan, device) and are cached; no host-to-device copy happens per call.
* **Chains lead.** Q.data is (nnz,) or (B, nnz); the factor holds vals
  (B, nnzL+1) with one DUMMY slot that stays 0, and the Jacobi scaling s
  (B, n). The logdet is differentiable through `SupernodalLogdet`, whose
  backward is the selected inverse on Q's pattern (K8 + K5) from the saved
  factor; `solve` is differentiable through `FactorSolve` (K7 forward and
  backward), and Σ through `SelectedInverse`, whose tangent pass
  (`_tangent_sigma`) scatters Q̇ onto the fill (K5), runs the
  factorization's tangent level by level (K20, and the Schur ELL by K5) and
  the Takahashi sweep's (K21). The triangular solves and `sqrt_matvec` go
  through `FactorTriangular`: L̄ gathered onto the fill by torch products,
  the factorization's reverse sweep level by level, descending (K25, A from
  K8's first entry), then Q̄ at the pattern's entries with the scaling
  undone (K5); Lᵀ z is K7's mode MULTIPLY_T.

* **A mesh (``mesh=``, a ``DeviceMesh``).** Each class batch of the scan
  levels is split over the ranks of the mesh's first dimension, padded with
  DUMMY panels; each rank launches K6 on its shard, and the new panels, log
  pivots and U are all-gathered for the replicated scatter and K5
  reduction. The top separators stay unsplit. Values equal the one-rank
  path's: each panel is factored by the same code, and no sum is reordered
  (reference ``supernodal.py:1105-1165``).

Not ported from the reference: the staged multi-dispatch path (a TPU
compile-helper workaround).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import (
    BACKWARD,
    FORWARD,
    InitPlan,
    SegPlan,
    fct_init,
    fct_init_plain,
    gather_segsum,
    gather_segsum_plain,
    sn_multiply,
    sn_multiply_plain,
    sn_panel,
    sn_panel_adjoint,
    sn_panel_adjoint_plain,
    sn_panel_plain,
    sn_panel_tangent,
    sn_panel_tangent_plain,
    sn_takahashi,
    sn_takahashi_prep,
    sn_takahashi_prep_plain,
    sn_takahashi_sweep_plain,
    sn_takahashi_tangent,
    sn_takahashi_tangent_plain,
    sn_trsv,
    sn_trsv_plain,
)
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .base import TRI_L, TRI_LINV, TRI_LINVT, DirectFactor, SelectedInverse, symmetric_weights

__all__ = [
    "SupernodalFactor",
    "SupernodalLogdet",
    "supernodal_factorize",
    "supernodal_plan",
    "supernodal_symbolic_summary",
]

_PLAN_CACHE: dict = {}

_SELINV_CACHE: dict = {}

# bump when the plan dict layout changes (invalidates the disk cache)
_PLAN_VERSION = 5

# plans below this size rebuild faster than they load: no disk cache
# (module-level so tests can lower it to exercise the round trip)
_DISK_MIN_N = 50_000

_TOP_MAX = 48  # supernode budget for the exactly-unrolled top segment


def _pow2_pad(x: int, floor: int = 8) -> int:
    if x <= 0:
        return 0
    p = floor
    while p < x:
        p *= 2
    return p


def _amalgamate(parent, counts, sn_start_f, max_width, tiers=None):
    """Relaxed-supernode amalgamation (CHOLMOD-style).

    Merges a fundamental supernode chain into its parent when the explicit
    zeros introduced stay under a width-tiered fraction (`tiers` =
    ((w1, z1), (w2, z2), ..., (inf, z_last)): merge if w <= w_k and
    z <= z_k for some tier; default (4,1)(16,.8)(48,.1)(inf,.05)). This is
    what keeps the level schedule shallow and the dense blocks MXU-sized at
    large n: nested-dissection separators collapse into single wide
    supernodes.

    Returns (sn_start_merged, top_first_col, m_merged) where top_first_col[s]
    is the first column of the parent-most fundamental constituent (whose
    below-supernode row set IS the merged supernode's row set, by the etree
    column-containment property) and m_merged[s] = |R_s|.
    """
    if tiers is None:
        tiers = ((4, 1.0), (16, 0.8), (48, 0.1), (np.inf, 0.05))
    nf = len(sn_start_f) - 1
    first_f = sn_start_f[:-1].astype(np.int64)
    ns_f = (sn_start_f[1:] - sn_start_f[:-1]).astype(np.int64)
    m_f = counts[first_f].astype(np.int64) - ns_f  # |R| per fundamental
    csum = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])

    # stack entries: [start_col, end_col, top_fund_idx, actual_nnz]
    st_s0 = np.empty(nf, np.int64)
    st_e1 = np.empty(nf, np.int64)
    st_top = np.empty(nf, np.int64)
    st_nnz = np.empty(nf, np.int64)
    top = -1
    for f in range(nf):
        s0 = int(first_f[f])
        e1 = s0 + int(ns_f[f])
        tf = f
        nnz = int(csum[e1] - csum[s0])
        while top >= 0:
            pe = int(st_e1[top])
            if pe != s0:
                break
            pcol = int(parent[pe - 1])
            if pcol < 0 or pcol >= e1:
                break  # last col of the stack top escapes this supernode
            w = e1 - int(st_s0[top])
            if w > max_width:
                break
            mR = int(m_f[tf])
            new_nnz = w * (w + 1) // 2 + w * mR
            act = nnz + int(st_nnz[top])
            z = 1.0 - act / new_nnz if new_nnz else 0.0
            ok = any(w <= tw and z <= tz for tw, tz in tiers)
            if not ok:
                break
            s0 = int(st_s0[top])
            nnz = act
            top -= 1
        top += 1
        st_s0[top] = s0
        st_e1[top] = e1
        st_top[top] = tf
        st_nnz[top] = nnz
    nm = top + 1
    sn_start = np.empty(nm + 1, np.int64)
    sn_start[:nm] = st_s0[:nm]
    sn_start[nm] = st_e1[nm - 1] if nm else 0
    top_first = first_f[st_top[:nm]]
    m_merged = m_f[st_top[:nm]]
    return sn_start, top_first, m_merged


def _symbolic_core(pattern: SparsePattern, max_width: int, ordering: str):
    """Cheap shared symbolic stage: ordering, etree, counts, supernodes
    (fundamental + amalgamated), levels — everything needed both for the
    solver-choice heuristic and for the full plan. Cached separately from
    the (expensive) index-map build."""
    key = ("core", pattern, max_width, ordering)
    core = _PLAN_CACHE.get(key)
    if core is not None:
        return core

    from .. import native
    import scipy.sparse as sp

    n = pattern.shape[0]
    S = pattern.to_scipy_bool()
    S = ((S + S.T) > 0).tocsr()
    S.sort_indices()
    ap0 = S.indptr.astype(np.int32)
    ai0 = S.indices.astype(np.int32)

    # 1) fill-reducing ordering + postorder composition. Nested dissection
    #    for large mesh-like patterns (bounded-depth etree, wide dense
    #    separator supernodes); AMD for small/irregular ones.
    if ordering == "auto":
        ordering = "nd" if n > 16384 else "amd"
    if ordering == "nd":
        base = native.nd_order(n, ap0, ai0)
    else:
        base = native.amd_order(n, ap0, ai0)
    P = sp.csr_matrix(
        (np.ones(n, np.int8), (np.arange(n), base)), shape=(n, n)
    )
    Sp = (P @ S @ P.T).tocsr()
    Sp.sort_indices()
    parent0 = native.etree(
        n, Sp.indptr.astype(np.int32), Sp.indices.astype(np.int32)
    )
    post = native.postorder(parent0)
    perm = base[post]  # perm[k] = original index of permuted column k
    Pf = sp.csr_matrix(
        (np.ones(n, np.int8), (np.arange(n), perm)), shape=(n, n)
    )
    Sf = (Pf @ S @ Pf.T).tocsr()
    Sf.sort_indices()
    apf = Sf.indptr.astype(np.int32)
    aif = Sf.indices.astype(np.int32)

    # 2) etree / counts / fundamental supernodes on the final ordering
    parent = native.etree(n, apf, aif)
    counts = native.col_counts(n, apf, aif, parent)
    snode_f = native.supernode_partition(parent, counts, max_width)
    nsf = int(snode_f[-1]) + 1 if n else 0
    sn_start_f = np.zeros(nsf + 1, dtype=np.int64)
    np.add.at(sn_start_f, snode_f.astype(np.int64) + 1, 1)
    sn_start_f = np.cumsum(sn_start_f)

    # 3) relaxed amalgamation → merged supernodes with explicit-zero padding.
    # Above ~2e5 nodes the tiers relax further: Σ M² (which sets both the
    # Schur index-table bytes and the padded update flops) is dominated by
    # mid-tree supernodes with modest widths and large row sets, and
    # merging those into wider panels cuts supernode count ~4x and table
    # memory ~30% at n=1e6 while feeding the MXU larger blocks. The policy
    # is a pure function of n, so plan cache keys stay (pattern, width,
    # ordering).
    tiers = (
        None
        if n <= 200_000
        else ((16, 1.0), (64, 0.8), (256, 0.35), (np.inf, 0.15))
    )
    sn_start, top_first, m_all = _amalgamate(
        parent, counts, sn_start_f, max_width, tiers
    )
    nsuper = len(sn_start) - 1
    ns_all = sn_start[1:] - sn_start[:-1]
    snode = np.repeat(np.arange(nsuper, dtype=np.int64), ns_all)

    levels = np.zeros(nsuper, dtype=np.int64)
    sn_parent = np.full(nsuper, -1, dtype=np.int64)
    last_cols = sn_start[1:] - 1
    pcols = parent[last_cols]
    has_p = pcols != -1
    sn_parent[has_p] = snode[pcols[has_p]]
    for s in range(nsuper):
        p = sn_parent[s]
        if p != -1:
            levels[p] = max(levels[p], levels[s] + 1)
    nlevels = int(levels.max()) + 1 if nsuper else 0

    # amalgamated per-column counts and flops
    counts2 = (
        np.arange(n, dtype=np.int64) * -1
        + sn_start[snode + 1]
        + m_all[snode]
    )
    # bucket census (no index maps): (level, ns_pad, m_pad) classes
    bucket_keys = {
        (int(levels[s]), _pow2_pad(int(ns_all[s]), 4), _pow2_pad(int(m_all[s]), 8))
        for s in range(nsuper)
    }

    core = dict(
        perm=perm,
        apf=apf,
        aif=aif,
        parent=parent,
        counts=counts,
        counts2=counts2,
        snode=snode,
        sn_start=sn_start,
        top_first=top_first,
        m_all=m_all,
        levels=levels,
        nlevels=nlevels,
        nsuper=nsuper,
        nbuckets=len(bucket_keys),
        flops=float(np.sum(counts2.astype(np.float64) ** 2)),
    )
    _PLAN_CACHE[key] = core
    return core


def supernodal_symbolic_summary(
    pattern: SparsePattern, max_width: int = 2048, ordering: str = "auto"
):
    """(flops, nbuckets, nlevels, nsuper) — cheap, for solver selection."""
    core = _symbolic_core(pattern, max_width, ordering)
    return dict(
        flops=core["flops"],
        nbuckets=core["nbuckets"],
        nlevels=core["nlevels"],
        nsuper=core["nsuper"],
    )


def _build_ell(tgts, srcs, dummy_tgt, zero_src):
    """Group (target, source) contribution pairs by target into a two-tier
    ELL layout: tier-1 rows of width K1 (≈ p95 multiplicity) for almost all
    targets, tier-2 exact-width rows for the heavy tail. All rows have
    unique targets, so the downstream scatter-adds carry
    `unique_indices=True` — the fast TPU lowering."""
    if len(tgts) == 0:
        return dict(
            t1=np.zeros(0, np.int32), s1=np.zeros((0, 1), np.int32),
            t2=np.zeros(0, np.int32), s2=np.zeros((0, 1), np.int32),
        )
    order = np.argsort(tgts, kind="stable")
    tgts = tgts[order]
    srcs = srcs[order]
    uniq, start, cnt = np.unique(tgts, return_index=True, return_counts=True)
    kmax = int(cnt.max())
    k1 = int(min(kmax, max(1, int(np.percentile(cnt, 95)))))
    heavy = cnt > k1
    # tier 1: first k1 contributions of every target
    T1 = len(uniq)
    s1 = np.full((T1, k1), zero_src, np.int32)
    for k in range(k1):
        sel = cnt > k
        s1[sel, k] = srcs[start[sel] + k]
    # tier 2: the remaining contributions of heavy targets
    if np.any(heavy):
        k2 = kmax - k1
        hidx = np.nonzero(heavy)[0]
        T2 = len(hidx)
        s2 = np.full((T2, k2), zero_src, np.int32)
        for j, h in enumerate(hidx):
            extra = srcs[start[h] + k1 : start[h] + cnt[h]]
            s2[j, : len(extra)] = extra
        t2 = uniq[hidx].astype(np.int32)
    else:
        t2 = np.zeros(0, np.int32)
        s2 = np.zeros((0, 1), np.int32)
    return dict(t1=uniq.astype(np.int32), s1=s1, t2=t2, s2=s2)


def _pad_ell_levels(ells, dummy_tgt, zero_src):
    """Stack per-level ELL dicts into scan xs arrays padded to the max
    (T, K) over levels."""
    nlev = len(ells)
    if nlev == 0:
        return None
    T1 = max(e["t1"].shape[0] for e in ells)
    K1 = max(e["s1"].shape[1] for e in ells)
    T2 = max(e["t2"].shape[0] for e in ells)
    K2 = max(e["s2"].shape[1] for e in ells)
    if T1 == 0 and T2 == 0:
        return None
    t1 = np.full((nlev, max(T1, 1)), dummy_tgt, np.int32)
    s1 = np.full((nlev, max(T1, 1), max(K1, 1)), zero_src, np.int32)
    t2 = np.full((nlev, max(T2, 1)), dummy_tgt, np.int32)
    s2 = np.full((nlev, max(T2, 1), max(K2, 1)), zero_src, np.int32)
    for i, e in enumerate(ells):
        a, b = e["t1"].shape[0], e["s1"].shape[1]
        t1[i, :a] = e["t1"]
        s1[i, :a, :b] = e["s1"]
        a, b = e["t2"].shape[0], e["s2"].shape[1]
        t2[i, :a] = e["t2"]
        s2[i, :a, :b] = e["s2"]
    return dict(
        t1=t1, s1=s1, t2=t2, s2=s2, has2=T2 > 0
    )


def _supernode_tables(group, lp, n, entry_key, W, M):
    """Exact per-supernode index tables for a list of (j0, ns, rows):
    panel_idx (B, W+M, W), schur_idx (B, M, M) gather table for Takahashi,
    cols_idx (B, W), rows_idx (B, M), col_mask (B, W)."""
    nnzL = len(entry_key)
    DUMMY = nnzL
    NDUMMY = n
    Bn = len(group)
    panel_idx = np.full((Bn, W + M, W), DUMMY, dtype=np.int32)
    schur_idx = np.full((Bn, M, M), DUMMY, dtype=np.int32)
    cols_idx = np.full((Bn, W), NDUMMY, dtype=np.int32)
    rows_idx = np.full((Bn, M), NDUMMY, dtype=np.int32)
    col_mask = np.zeros((Bn, W), dtype=bool)
    for b, (j0, ns, rows) in enumerate(group):
        m = len(rows)
        cols_idx[b, :ns] = np.arange(j0, j0 + ns)
        col_mask[b, :ns] = True
        rows_idx[b, :m] = rows
        base = lp[j0 : j0 + ns]
        rr, cc = np.tril_indices(ns)
        panel_idx[b, rr, cc] = base[cc] + (rr - cc)
        if m:
            c_arr = np.arange(ns, dtype=np.int64)
            panel_idx[b, W : W + m, :ns] = (
                base[None, :]
                + (ns - c_arr)[None, :]
                + np.arange(m)[:, None]
            )
            pp, qq = np.tril_indices(m)
            keys = rows[qq].astype(np.int64) * n + rows[pp]
            schur_idx[b, pp, qq] = np.searchsorted(entry_key, keys)
    return dict(
        W=W,
        M=M,
        panel_idx=panel_idx,
        schur_idx=schur_idx,
        cols_idx=cols_idx,
        rows_idx=rows_idx,
        col_mask=col_mask,
    )


def supernodal_plan(
    pattern: SparsePattern, max_width: int = 2048, ordering: str = "auto"
):
    """Build (and cache) the full symbolic plan for `pattern`.

    The plan targets the *amalgamated* fill pattern: each merged supernode
    stores a dense (w×w lower + m×w) panel in flat CSC order, including the
    explicit zeros amalgamation introduced. Produces the two-segment
    schedule described in the module docstring: scan classes (flat tables +
    per-level offset/count) for levels < ℓ*, exact unrolled buckets for the
    ≤48-supernode top, and per-level ELL reduction tables for the Schur and
    forward-solve updates.
    """
    key = (pattern, max_width, ordering)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    disk = _disk_path(pattern, max_width, ordering)
    if disk is not None:
        plan = _load_plan(disk)
        if plan is not None:
            _PLAN_CACHE[key] = plan
            return plan

    from .. import native

    core = _symbolic_core(pattern, max_width, ordering)
    n = pattern.shape[0]
    perm = core["perm"]
    apf, aif = core["apf"], core["aif"]
    parent, counts = core["parent"], core["counts"]
    sn_start, levels = core["sn_start"], core["levels"]
    top_first, m_all = core["top_first"], core["m_all"]
    nsuper, nlevels = core["nsuper"], core["nlevels"]
    counts2 = core["counts2"]

    # fundamental fill — only needed to read each merged supernode's row set
    lp_f, li_f = native.symbolic_fill(n, apf, aif, parent, counts)

    # synthesize the amalgamated CSC fill: column j of supernode s holds
    # rows [j .. j1) followed by R_s (sorted, all > j1-1)
    lp = np.zeros(n + 1, dtype=np.int64)
    lp[1:] = np.cumsum(counts2)
    nnzL = int(lp[-1])
    li = np.empty(nnzL, dtype=np.int32)
    sn_rows: list = []
    for s in range(nsuper):
        j0 = int(sn_start[s])
        j1 = int(sn_start[s + 1])
        ns = j1 - j0
        jt = int(top_first[s])
        wt = j1 - jt
        R = li_f[lp_f[jt] + wt : lp_f[jt + 1]]
        m = len(R)
        sn_rows.append(R)
        base = lp[j0 : j0 + ns]  # (ns,) start offsets per column
        rr, cc = np.tril_indices(ns)
        li[base[cc] + (rr - cc)] = j0 + rr
        if m:
            c_arr = np.arange(ns, dtype=np.int64)
            idx = base[None, :] + (ns - c_arr)[None, :] + np.arange(m)[:, None]
            li[idx] = R[:, None]

    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)

    # A(original canonical entries) -> vals scatter map (lower triangle only)
    pr = inv_perm[pattern.rows]
    pc = inv_perm[pattern.cols]
    lower = pr >= pc
    a_src = np.nonzero(lower)[0].astype(np.int32)
    lr = pr[lower]
    lc = pc[lower]
    # vectorized position lookup: key-sort (col, row) of L entries once,
    # then one batched searchsorted for all of A's lower entries
    col_of_entry = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(lp).astype(np.int64)
    )
    entry_key = col_of_entry * n + li.astype(np.int64)  # sorted ascending
    a_dst = np.searchsorted(entry_key, lc.astype(np.int64) * n + lr).astype(
        np.int32
    )

    DUMMY = nnzL  # one dummy slot appended to vals
    NDUMMY = n  # dummy slot for length-(n+1) vectors

    ns_all = (sn_start[1:] - sn_start[:-1]).astype(np.int64)

    # ---- schedule split: scan levels [0, lstar), unrolled top [lstar, end)
    lev_counts = np.bincount(levels, minlength=max(nlevels, 1))
    suffix = np.cumsum(lev_counts[::-1])[::-1]
    cand = np.nonzero(suffix <= _TOP_MAX)[0]
    lstar = int(cand[0]) if len(cand) else nlevels
    if nsuper <= _TOP_MAX:
        lstar = 0

    # ---- scan-segment choice: a single scan over [0, lstar) would process
    # EVERY class at EVERY level (a class active only on levels 0..2 still
    # pays padded dummy compute on levels 3..lstar — measured ~2.5x waste at
    # 14k nodes). Partition the level axis into contiguous segments, each
    # carrying only its active classes, via a small DP on a slot-cost proxy.
    cls_of = {}
    for s in range(nsuper):
        if levels[s] < lstar:
            ck = (_pow2_pad(int(ns_all[s]), 4), _pow2_pad(len(sn_rows[s]), 8))
            cls_of.setdefault(ck, []).append(s)
    all_keys = sorted(cls_of)
    slot_cost = {
        (W, M): (W + M) * W + M * M + 8 * W for (W, M) in all_keys
    }
    cnt_mat = {
        k: np.bincount(
            levels[np.asarray(cls_of[k], np.int64)], minlength=max(lstar, 1)
        )[:lstar]
        for k in all_keys
    }

    # Segment-choice DP on a slot-cost proxy. Candidate segment length is
    # bounded (deep etrees would otherwise make this O(lstar² · nclasses) —
    # minutes of host work on quasi-1D patterns); per-(i,j) cost is an O(nk)
    # vectorized running max as j walks down, so the whole DP is
    # O(lstar · MAXSEG · nclasses) numpy work. Splitting a >MAXSEG optimal
    # segment costs at most one extra SEG_OVERHEAD per MAXSEG levels.
    SEG_OVERHEAD = 3.0e6  # compile/launch cost charged per extra segment
    MAXSEG = 64
    nk = len(all_keys)
    Cm = (
        np.stack([cnt_mat[k] for k in all_keys]).astype(np.float64)
        if nk
        else np.zeros((0, max(lstar, 1)))
    )
    wcost = np.asarray([slot_cost[k] for k in all_keys], np.float64)
    best = np.full(lstar + 1, np.inf)
    best[0] = 0.0
    argb = np.zeros(lstar + 1, np.int64)
    for i in range(1, lstar + 1):
        mx = np.zeros(nk)
        for j in range(i - 1, max(0, i - MAXSEG) - 1, -1):
            mx = np.maximum(mx, Cm[:, j])
            v = best[j] + (i - j) * float(mx @ wcost) + SEG_OVERHEAD
            if v < best[i]:
                best[i], argb[i] = v, j
    bounds = []
    i = lstar
    while i > 0:
        bounds.append((int(argb[i]), i))
        i = int(argb[i])
    bounds.reverse()

    def _build_scan_segment(lo, hi):
        """Self-contained scan segment: per-class flat tables over levels
        [lo, hi) plus the per-level ELL reductions in that range."""
        classes = []
        sn_slot_l = {}
        sn_cls_l = {}
        for ci, k in enumerate(
            [k for k in all_keys if cnt_mat[k][lo:hi].sum() > 0]
        ):
            W, M = k
            members = [s for s in cls_of[k] if lo <= levels[s] < hi]
            members = sorted(members, key=lambda s: (levels[s], sn_start[s]))
            lv = levels[np.asarray(members, np.int64)] - lo
            cnt = np.bincount(lv, minlength=hi - lo)[: hi - lo].astype(np.int32)
            off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
            P = int(cnt.max())
            group = [
                (int(sn_start[s]), int(ns_all[s]), sn_rows[s]) for s in members
            ]
            tb = _supernode_tables(group, lp, n, entry_key, W, M)

            def padrow(a, fill):
                pad = np.full((P,) + a.shape[1:], fill, a.dtype)
                return np.concatenate([a, pad], axis=0)

            classes.append(
                dict(
                    W=W,
                    M=M,
                    P=P,
                    off=off,
                    cnt=cnt,
                    dummy=DUMMY,
                    ndummy=NDUMMY,
                    panel_idx=padrow(tb["panel_idx"], DUMMY),
                    schur_idx=padrow(tb["schur_idx"], DUMMY),
                    cols_idx=padrow(tb["cols_idx"], NDUMMY),
                    rows_idx=padrow(tb["rows_idx"], NDUMMY),
                    col_mask=padrow(tb["col_mask"], False),
                )
            )
            for si, mem in enumerate(members):
                sn_slot_l[mem] = si - off[levels[mem] - lo]
                sn_cls_l[mem] = ci
        ubase = np.zeros(len(classes) + 1, np.int64)
        fbase = np.zeros(len(classes) + 1, np.int64)
        for ci, c in enumerate(classes):
            ubase[ci + 1] = ubase[ci] + c["P"] * c["M"] * c["M"]
            fbase[ci + 1] = fbase[ci] + c["P"] * c["M"]
        ZU, ZF = int(ubase[-1]), int(fbase[-1])

        schur_ells, fwd_ells = [], []
        for lev in range(lo, hi):
            tg, sr, ftg, fsr = [], [], [], []
            for s in np.nonzero(levels == lev)[0]:
                rows = sn_rows[s]
                m = len(rows)
                if m == 0:
                    continue
                ci = sn_cls_l[s]
                M = classes[ci]["M"]
                ub, fb = int(ubase[ci]), int(fbase[ci])
                slot = int(sn_slot_l[s])
                pp, qq = np.tril_indices(m)
                keys = rows[qq].astype(np.int64) * n + rows[pp]
                tg.append(np.searchsorted(entry_key, keys).astype(np.int32))
                sr.append((ub + (slot * M + pp) * M + qq).astype(np.int32))
                ftg.append(rows.astype(np.int32))
                fsr.append((fb + slot * M + np.arange(m)).astype(np.int32))
            cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int32)
            schur_ells.append(_build_ell(cat(tg), cat(sr), DUMMY, ZU))
            fwd_ells.append(_build_ell(cat(ftg), cat(fsr), NDUMMY, ZF))
        return dict(
            lo=lo,
            hi=hi,
            classes=classes,
            schur=_pad_ell_levels(schur_ells, DUMMY, ZU),
            fwd=_pad_ell_levels(fwd_ells, NDUMMY, ZF),
        )

    segments = [_build_scan_segment(lo, hi) for lo, hi in bounds]

    # needed by the top-level ELL builder below
    sn_slot = np.zeros(nsuper, np.int64)
    sn_cls = np.full(nsuper, -1, np.int64)

    # ---- top segment: exact per-level buckets
    top_buckets: list = [[] for _ in range(nlevels - lstar)]
    top_u_off: list = [[] for _ in range(nlevels - lstar)]  # per bucket ravel offset
    for lev in range(lstar, nlevels):
        buckets: dict = {}
        for s in np.nonzero(levels == lev)[0]:
            ck = (_pow2_pad(int(ns_all[s]), 4), _pow2_pad(len(sn_rows[s]), 8))
            buckets.setdefault(ck, []).append(s)
        uoff = 0
        for (W, M), members in sorted(buckets.items()):
            members = sorted(members, key=lambda s: sn_start[s])
            group = [
                (int(sn_start[s]), int(ns_all[s]), sn_rows[s]) for s in members
            ]
            tb = _supernode_tables(group, lp, n, entry_key, W, M)
            top_buckets[lev - lstar].append(tb)
            top_u_off[lev - lstar].append(uoff)
            for b, s in enumerate(members):
                sn_slot[s] = b
                sn_cls[s] = -(len(top_buckets[lev - lstar]))  # bucket idx enc
            uoff += len(members) * W * M * 0  # placeholder, not used
        # record per-supernode (bucket, slot) for ELL src below via sn_cls/sn_slot

    # ---- ELL reduction tables for the top (unrolled) levels: exact, the
    # sources index that level's concat of bucket Us
    def top_level_ells(lev):
        tg, sr, ftg, fsr = [], [], [], []
        tb_list = top_buckets[lev - lstar]
        cum_u = np.concatenate(
            [[0], np.cumsum([t["schur_idx"].shape[0] * t["M"] ** 2 for t in tb_list])]
        )
        cum_f = np.concatenate(
            [[0], np.cumsum([t["rows_idx"].shape[0] * t["M"] for t in tb_list])]
        )
        zslot, fzslot = int(cum_u[-1]), int(cum_f[-1])
        for s in np.nonzero(levels == lev)[0]:
            rows = sn_rows[s]
            m = len(rows)
            if m == 0:
                continue
            slot = int(sn_slot[s])
            bi = -int(sn_cls[s]) - 1
            M = tb_list[bi]["M"]
            ub, fb = int(cum_u[bi]), int(cum_f[bi])
            pp, qq = np.tril_indices(m)
            keys = rows[qq].astype(np.int64) * n + rows[pp]
            tg.append(np.searchsorted(entry_key, keys).astype(np.int32))
            sr.append((ub + (slot * M + pp) * M + qq).astype(np.int32))
            ftg.append(rows.astype(np.int32))
            fsr.append((fb + slot * M + np.arange(m)).astype(np.int32))
        cat = lambda xs: (
            np.concatenate(xs) if xs else np.zeros(0, np.int32)
        )
        return (
            _build_ell(cat(tg), cat(sr), DUMMY, zslot),
            _build_ell(cat(ftg), cat(fsr), NDUMMY, fzslot),
        )

    top_schur_ells, top_fwd_ells = [], []
    for lev in range(lstar, nlevels):
        se, fe = top_level_ells(lev)
        top_schur_ells.append(se)
        top_fwd_ells.append(fe)

    # the diagonal entry is emitted first in every column of L
    diag_pos = lp[:-1].astype(np.int32)

    plan = dict(
        n=n,
        nnzL=nnzL,
        perm=perm.astype(np.int32),
        inv_perm=inv_perm.astype(np.int32),
        lp=lp,
        li=li,
        a_src=a_src,
        a_dst=a_dst,
        entry_key=entry_key,
        diag_pos=diag_pos,
        nlevels=nlevels,
        nsuper=nsuper,
        flops=core["flops"],
        lstar=lstar,
        segments=segments,
        top_buckets=top_buckets,
        top_schur_ells=top_schur_ells,
        top_fwd_ells=top_fwd_ells,
    )
    _PLAN_CACHE[key] = plan
    if disk is not None:
        _save_plan(disk, plan)
    return plan


# ---- the plan's disk cache ----------------------------------------------------------


def _disk_path(pattern: SparsePattern, max_width: int, ordering: str):
    """The cache file of a plan of n >= _DISK_MIN_N under $TPU_GMRF_PLAN_CACHE
    (None below that size or without the variable): keyed by the pattern's
    content hash, the width, the ordering and the format version."""
    root = os.environ.get("TPU_GMRF_PLAN_CACHE")
    if pattern.shape[0] < _DISK_MIN_N or not root:
        return None
    tag = hashlib.sha1(pattern._digest + f"|{max_width}|{ordering}|v{_PLAN_VERSION}".encode()).hexdigest()[:24]
    return os.path.join(root, f"plan_{pattern.shape[0]}_{tag}.npz")


def _flatten(obj, path: str, arrays: dict):
    """A JSON skeleton of the plan, its arrays moved into `arrays` by path."""
    if isinstance(obj, dict):
        return {"d": {k: _flatten(v, f"{path}/{k}", arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"l": [_flatten(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]}
    if isinstance(obj, np.ndarray):
        arrays[path] = obj
        return {"a": path}
    if obj is None:
        return None
    if isinstance(obj, (bool, np.bool_)):
        return {"b": bool(obj)}
    if isinstance(obj, (int, np.integer)):
        return {"i": int(obj)}
    if isinstance(obj, (float, np.floating)):
        return {"f": float(obj)}
    raise TypeError(f"plan entry {path} of type {type(obj).__name__}")


def _unflatten(node, arrays):
    if node is None:
        return None
    (kind, v), = node.items()
    if kind == "d":
        return {k: _unflatten(x, arrays) for k, x in v.items()}
    if kind == "l":
        return [_unflatten(x, arrays) for x in v]
    if kind == "a":
        return arrays[v]
    return {"b": bool, "i": int, "f": float}[kind](v)


def _save_plan(path: str, plan: dict) -> None:
    arrays: dict = {}
    skeleton = _flatten(plan, "", arrays)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, __version__=np.array(_PLAN_VERSION), __skeleton__=np.array(json.dumps(skeleton)),
             **{f"a{i}": a for i, a in enumerate(arrays.values())},
             __names__=np.array(json.dumps(list(arrays))))
    os.replace(tmp, path)


def _load_plan(path: str):
    """The plan stored at `path`, or None when the file is missing, unreadable
    or of another format version (then it is rebuilt and written anew)."""
    try:
        with np.load(path, allow_pickle=False) as f:
            if int(f["__version__"]) != _PLAN_VERSION:
                return None
            names = json.loads(str(f["__names__"]))
            arrays = {name: f[f"a{i}"] for i, name in enumerate(names)}
            return _unflatten(json.loads(str(f["__skeleton__"])), arrays)
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


# ---- device half: tables on the device, once per (plan, device) -------------------

_DEVICE_CACHE: dict = {}

_KERNEL_OPS = dict(init=fct_init, panel=sn_panel, trsv=sn_trsv, multiply=sn_multiply, prep=sn_takahashi_prep,
                   takahashi=sn_takahashi, segsum=gather_segsum, panel_tangent=sn_panel_tangent,
                   takahashi_tangent=sn_takahashi_tangent, panel_adjoint=sn_panel_adjoint)
# the plain versions, for comparisons of the kernels with them on the card
_PLAIN_OPS = dict(init=fct_init_plain, panel=sn_panel_plain, trsv=sn_trsv_plain, multiply=sn_multiply_plain,
                  prep=sn_takahashi_prep_plain, takahashi=sn_takahashi_sweep_plain, segsum=gather_segsum_plain,
                  panel_tangent=sn_panel_tangent_plain, takahashi_tangent=sn_takahashi_tangent_plain,
                  panel_adjoint=sn_panel_adjoint_plain)


@dataclasses.dataclass
class _Level:
    """One level of the schedule: its class batches, the sizes of its update
    buffers (Schur ``zu``, forward-solve ``zf``; one zero slot each is
    appended) and its ELL reductions as K5 plans (one each, or none)."""

    classes: list
    zu: int
    zf: int
    schur: list
    fwd: list
    top: bool = False  # a top-separator level: never split over a mesh

    def __post_init__(self):
        # K6 and K7 take the level's batches as one group: one launch for K7, one per path for K6
        self.group = dict(classes=self.classes)


def _ell_plans(ell, lev, dummy_tgt, zero_src):
    """One level's two ELL tiers as one ragged K5 plan (in a list; empty when
    the level has no update): a row per target holding all of its
    contributions (the tiers write the same heavy targets, so one launch
    needs them in one row), tier 1's and then tier 2's as the row's two parts,
    which K5 adds in turn as the reference's two scatter-adds do; the padding
    that reads the zero slot dropped."""
    if ell is None:
        return []
    tgt, src, tier = [], [], []
    for i, (t, s) in enumerate(((ell["t1"], ell["s1"]), (ell["t2"], ell["s2"]))):
        if lev is not None:
            t, s = t[lev], s[lev]
        live = t != dummy_tgt
        tt, ss = np.repeat(t[live], s.shape[1]), s[live].ravel()
        keep = ss != zero_src
        tgt.append(tt[keep])
        src.append(ss[keep])
        tier.append(np.full(int(keep.sum()), i))
    tgt, src, tier = np.concatenate(tgt), np.concatenate(src), np.concatenate(tier)
    if not len(tgt):
        return []
    targets, row = np.unique(tgt, return_inverse=True)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=len(targets)))])
    return [SegPlan(src[np.argsort(row, kind="stable")], ptr=ptr, t=targets,
                    split=np.bincount(row[tier == 0], minlength=len(targets)))]


def _one_term(xi, t=None, yi=None, zi=None, rows=None):
    """K5 plan with one term per row (and empty rows up to `rows`)."""
    xi = np.asarray(xi)
    ptr = np.arange(len(xi) + 1)
    if rows is not None:
        ptr = np.concatenate([ptr, np.full(rows - len(xi), len(xi))])
    return SegPlan(xi, ptr=ptr, t=t, yi=yi, zi=zi)


@functools.lru_cache(maxsize=None)
def _sum_plan(m, dot=False):
    """The K5 plan that sums m terms per chain (x·y with `dot`) in one row: one
    launch (from BLOCK_TERMS terms, a block per chunk of CHUNK_TERMS). Cached,
    with its device tables."""
    return SegPlan(np.arange(m), ptr=[0, m], yi=np.arange(m) if dot else None)


def _device_plan(meta, device):
    key = (meta, str(device))
    dp = _DEVICE_CACHE.get(key)
    if dp is not None:
        return dp
    plan = _PLAN_CACHE[meta]
    n, nnzL = plan["n"], plan["nnzL"]
    DUMMY, NDUMMY = nnzL, n

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=device)

    def batch(W, M, panel, cols, rows, schur, ubase, fbase):
        return dict(W=W, M=M, panel=panel, cols=cols, rows=rows, schur=schur, ubase=ubase,
                    fbase=fbase, dummy=DUMMY, ndummy=NDUMMY)

    levels = []
    for seg in plan["segments"]:
        tabs, ub, fb = [], 0, 0
        for c in seg["classes"]:
            tabs.append((c, [i32(c[k]) for k in ("panel_idx", "cols_idx", "rows_idx", "schur_idx")], ub, fb))
            ub += c["P"] * c["M"] * c["M"]
            fb += c["P"] * c["M"]
        for lev in range(seg["hi"] - seg["lo"]):
            classes = []
            for c, t, ubase, fbase in tabs:
                cnt, off = int(c["cnt"][lev]), int(c["off"][lev])
                if cnt:
                    classes.append(batch(c["W"], c["M"], *(a[off:off + cnt] for a in t), ubase, fbase))
            levels.append(_Level(classes, ub, fb, _ell_plans(seg["schur"], lev, DUMMY, ub),
                                 _ell_plans(seg["fwd"], lev, NDUMMY, fb)))
    for li in range(plan["nlevels"] - plan["lstar"]):
        classes, ub, fb = [], 0, 0
        for bk in plan["top_buckets"][li]:
            P, M = bk["panel_idx"].shape[0], bk["M"]
            classes.append(batch(bk["W"], M, *(i32(bk[k]) for k in ("panel_idx", "cols_idx", "rows_idx", "schur_idx")),
                                 ub, fb))
            ub += P * M * M
            fb += P * M
        levels.append(_Level(classes, ub, fb, _ell_plans(plan["top_schur_ells"][li], None, DUMMY, ub),
                             _ell_plans(plan["top_fwd_ells"][li], None, NDUMMY, fb), top=True))
    perm, pattern = plan["perm"], meta[0]
    dp = dict(
        levels=levels,
        prep=_prep_batches([c for lv in levels for c in lv.classes]),
        init=InitPlan(pattern.transpose_perm, pattern.diag_positions, pattern.rows, pattern.cols,
                      plan["a_src"], plan["a_dst"]),
        perm=_one_term(perm, yi=perm, rows=n + 1),  # (s·b)[perm], then the NDUMMY zero
        unperm=_one_term(np.arange(n), t=perm, yi=perm),  # x[perm] = s·xp
        diag=_one_term(plan["diag_pos"], t=perm, yi=perm, zi=perm),  # s·s·Σ_diag, unpermuted
        logdet=_sum_plan(2 * n),  # Σ log pivots + Σ -log s
        perm_l=torch.as_tensor(np.asarray(perm, np.int64), device=device),  # the torch gathers of the adjoint
        inv_perm_l=torch.as_tensor(np.asarray(plan["inv_perm"], np.int64), device=device),
    )
    plans = [dp["init"], dp["perm"], dp["unperm"], dp["diag"], dp["logdet"]]
    for lv in levels:
        plans += lv.schur + lv.fwd
    for p in plans:
        p.tensors(device)
    _DEVICE_CACHE[key] = dp
    return dp


def _prep_batches(classes) -> list:
    """Class batches merged by shape (W, M) whatever their level: the batches
    of K8's first entry, whose work does not depend on Σ."""
    groups: dict = {}
    for c in classes:
        groups.setdefault((c["W"], c["M"]), []).append(c)
    return [dict(W=W, M=M, panel=torch.cat([c["panel"] for c in cs]), cols=torch.cat([c["cols"] for c in cs]),
                 dummy=cs[0]["dummy"], ndummy=cs[0]["ndummy"]) for (W, M), cs in groups.items()]


def _buffer(ref: torch.Tensor, rows: int, size: int):
    """A level's update buffer (rows, size + 1); only its zero slot is set."""
    if size == 0:
        return None
    u = ref.new_empty(rows, size + 1)
    u[:, size] = 0.0
    return u


# ---- numeric factorization --------------------------------------------------------


def _shard(c: dict, rank: int, world: int):
    """Rank `rank`'s shard of class batch `c` as a group of one batch (K6's
    input form): ceil(P / world) panels, padded with DUMMY panels, its U at
    offset 0 of a buffer of its own; plus the device indices that read its
    results and write the gathered ones back (cached on `c`)."""
    key = ("_shard", rank, world)
    got = c.get(key)
    if got is None:
        P = c["panel"].shape[0]
        Pp = -(-P // world)

        def part(name, fill):
            t = c[name][rank * Pp: (rank + 1) * Pp]
            pad = t.new_full((Pp - t.shape[0],) + tuple(c[name].shape[1:]), fill)
            return torch.cat([t, pad]).contiguous()

        sc = {k: v for k, v in c.items() if not isinstance(k, tuple)}
        sc.update(panel=part("panel", c["dummy"]), cols=part("cols", c["ndummy"]), rows=part("rows", c["ndummy"]),
                  schur=part("schur", c["dummy"]), ubase=0, fbase=0)
        panel, cols = c["panel"].long().flatten(), c["cols"].long().flatten()
        live, lcol = panel != c["dummy"], cols != c["ndummy"]
        got = c[key] = dict(group=dict(classes=[sc]), Pp=Pp, read_p=sc["panel"].long().flatten(), read_c=sc["cols"].long().flatten(),
                            live=live, pos=panel[live], lcol=lcol, col=cols[lcol])
    return got


def _panel_sharded(ops, vals, c, u, logs, boost, group):
    """K6 on this rank's shard of class batch `c`, then one all-gather of the
    shards' panels, log pivots and U, written back as one launch on the whole
    batch would have written them."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    sh = _shard(c, rank, world)
    W, M, P, Pp, B = c["W"], c["M"], c["panel"].shape[0], sh["Pp"], vals.shape[0]
    ul = _buffer(vals, B, Pp * M * M)
    bl = torch.zeros_like(boost)
    ops["panel"](vals, sh["group"], ul, logs, bl)
    mine = [vals[:, sh["read_p"]], logs[:, sh["read_c"]]] + ([ul[:, : Pp * M * M]] if M else [])
    sizes = [t.shape[1] for t in mine]
    mine = torch.cat(mine, 1).contiguous()
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    dist.all_reduce(bl, group=group)
    got = [torch.cat(p, 1) for p in zip(*(t.split(sizes, 1) for t in parts))]  # rank-major = the padded batch
    vals[:, sh["pos"]] = got[0][:, : P * (W + M) * W][:, sh["live"]]
    logs[:, sh["col"]] = got[1][:, : P * W][:, sh["lcol"]]
    if M:
        u[:, c["ubase"]: c["ubase"] + P * M * M] = got[2][:, : P * M * M]
    boost += bl


def _factor_values(data, meta, ops, mesh=None):
    """(vals, s, logdet (B,), boost (B,) int32) of B precisions over one pattern.

    K5's `fct_init` symmetrizes, equilibrates and scatters A onto the fill
    pattern; K6 factors each class batch (with a mesh, each rank a shard of
    the scan levels' batches), K5 applies each level's Schur updates;
    logdet = 2(Σ log pivots − Σ log s) is one K5 sum over the log pivots (K6)
    and the -log s (`fct_init`) side by side in one buffer."""
    plan = _PLAN_CACHE[meta]
    dp = _device_plan(meta, data.device)
    B, n = data.shape[0], plan["n"]
    vals = data.new_zeros(B, plan["nnzL"] + 1)
    s = data.new_empty(B, n)
    logs = data.new_empty(B, 2 * n)  # [log pivots | -log s]
    ops["init"](dp["init"], data.contiguous(), vals, s, logs[:, n:])
    boost = torch.zeros(B, dtype=torch.int32, device=data.device)
    group = None if mesh is None else mesh.get_group(0)
    for lv in dp["levels"]:
        u = _buffer(vals, B, lv.zu)
        if group is None or lv.top:
            ops["panel"](vals, lv.group, u, logs, boost)
        else:
            for c in lv.classes:
                _panel_sharded(ops, vals, c, u, logs, boost, group)
        for ell in lv.schur:
            ops["segsum"](ell, u, out=vals, alpha=-1.0, accumulate=True)
    logdet = ops["segsum"](dp["logdet"], logs, alpha=2.0)
    return vals, s, logdet[:, 0], boost


def _prep_vals(vals, meta, ops):
    """C = Lb·Ld⁻¹ and A = Ld⁻ᵀLd⁻¹ of every supernode, laid out like vals (B,
    nnzL+1): K8's first entry, one launch per class shape."""
    pre = torch.zeros_like(vals)
    for c in _device_plan(meta, vals.device)["prep"]:
        ops["prep"](vals, pre, c)
    return pre


def _sigma_prep(vals, meta, ops):
    """Block Takahashi recursion: (pre, Σ) on L's pattern in the scaled basis,
    (B, nnzL+1) each: pre from `_prep_vals`, then K8 per class batch, levels
    descending."""
    dp = _device_plan(meta, vals.device)
    pre, sig = _prep_vals(vals, meta, ops), torch.zeros_like(vals)
    for lv in reversed(dp["levels"]):
        for c in lv.classes:
            ops["takahashi"](pre, sig, c)
    return pre, sig


def _sigma_vals(vals, meta, ops):
    """Σ on L's pattern in the scaled basis, (B, nnzL+1)."""
    return _sigma_prep(vals, meta, ops)[1]


def _scatter_plan(meta, where):
    """K5 plan putting T, given on `where`'s entries (an int n: the
    diagonal), onto the fill's lower positions in the scaled basis:
    row pos gets Σ t_p·s_{row p}·s_{col p} over the entries at pos."""
    key = (meta, where, "scatter")
    got = _SELINV_CACHE.get(key)
    if got is None:
        plan = _PLAN_CACHE[meta]
        if isinstance(where, int):
            rows = cols = np.arange(where)
            pos = np.asarray(plan["diag_pos"], np.int64)[plan["inv_perm"]]
        else:
            rows, cols = where.rows, where.cols
            pos = _selinv_positions(meta, where)[0].astype(np.int64)
        order = np.argsort(pos, kind="stable")
        ptr = np.concatenate([[0], np.cumsum(np.bincount(pos, minlength=plan["nnzL"] + 1))])
        got = _SELINV_CACHE[key] = SegPlan(order, ptr=ptr, yi=np.asarray(rows)[order], zi=np.asarray(cols)[order])
    return got


def _factor_tangent(vals, s, pre, t, where, meta, ops):
    """L̇' on L's pattern in the scaled basis, (B, nnzL+1), for Q̇' = S·sym(T)·S
    with T given by t (B, m) on `where`'s entries: T onto the fill (K5), then
    the factorization's tangent level by level (K20, the Schur ELL by K5);
    pre from `_prep_vals`."""
    dp = _device_plan(meta, vals.device)
    w = symmetric_weights(where, t.device, t.dtype)
    dvals = ops["segsum"](_scatter_plan(meta, where), (t if w is None else t * w).contiguous(), y=s, z=s)
    for lv in dp["levels"]:
        du = _buffer(vals, vals.shape[0], lv.zu)
        for c in lv.classes:
            ops["panel_tangent"](vals, pre, dvals, c, du)
        for ell in lv.schur:
            ops["segsum"](ell, du, out=dvals, alpha=-1.0, accumulate=True)
    return dvals


def _tangent_sigma(vals, s, t, where, meta, ops):
    """Σ̇' = −Σ'·Q̇'·Σ' on L's pattern in the scaled basis, (B, nnzL+1), for
    Q̇' = S·sym(T)·S with T given by t (B, m) on `where`'s entries: the
    factorization's tangent (`_factor_tangent`), then the Takahashi sweep's
    (K21), levels descending."""
    dp = _device_plan(meta, vals.device)
    pre, sig = _sigma_prep(vals, meta, ops)
    dvals = _factor_tangent(vals, s, pre, t, where, meta, ops)
    dsig = torch.zeros_like(vals)
    for lv in reversed(dp["levels"]):
        for c in lv.classes:
            ops["takahashi_tangent"](vals, pre, dvals, sig, dsig, c)
    return dsig


def _selinv_positions(meta, pattern: SparsePattern):
    key = (meta, pattern)
    got = _SELINV_CACHE.get(key)
    if got is None:
        plan = _PLAN_CACHE[meta]
        n = plan["n"]
        entry_key = plan["entry_key"]
        pr = plan["inv_perm"][pattern.rows].astype(np.int64)
        pc = plan["inv_perm"][pattern.cols].astype(np.int64)
        lo = np.minimum(pr, pc)
        hi = np.maximum(pr, pc)
        keys = lo * n + hi
        posv = np.searchsorted(entry_key, keys)
        if np.any(posv >= len(entry_key)) or np.any(
            entry_key[np.minimum(posv, len(entry_key) - 1)] != keys
        ):
            raise ValueError("selinv pattern entry outside the Cholesky fill pattern")
        posv = posv.astype(np.int32)
        got = (posv, _one_term(posv, yi=pattern.rows, zi=pattern.cols))
        _SELINV_CACHE[key] = got
    return got


def _selinv_data(vals, s, pattern, meta, ops, sig=None):
    """Σ_ij on `pattern`'s entries (an int n: the diagonal) with the scaling
    undone, s_i·Σ_ij·s_j (B, m), from Σ on L's pattern (`sig`, by default
    the Takahashi recursion's)."""
    sig = _sigma_vals(vals, meta, ops) if sig is None else sig
    if isinstance(pattern, int):
        dp = _device_plan(meta, vals.device)
        return ops["segsum"](dp["diag"], sig, y=s, z=s, out=sig.new_empty(sig.shape[0], pattern))
    _, plan = _selinv_positions(meta, pattern)
    return ops["segsum"](plan, sig, y=s, z=s)


class SupernodalLogdet(torch.autograd.Function):
    """logdet of B precisions (data (B, nnz)) by the supernodal factorization,
    with the factor (vals, s, boost) as non-differentiable outputs.

    Backward: ∂logdet/∂data_p = Σ_{row p, col p}: the reference averages both
    stored triangles before factoring, so each stored entry of a symmetric
    pair gets Σ_ij (the gradient JAX's AD gives whenever no pivot was
    boosted). Σ comes from the saved factor by K8 and K5 through
    `SelectedInverse`, differentiable in data; no refactorization. jvp:
    Σ_p Σ_{row p, col p} data̅'s tangent_p."""

    @staticmethod
    def forward(ctx, data, meta, mesh=None):
        vals, s, logdet, boost = _factor_values(data, meta, _KERNEL_OPS, mesh)
        ctx.mark_non_differentiable(vals, s, boost)
        ctx.save_for_backward(data, vals, s)
        ctx.save_for_forward(data, vals, s)
        ctx.meta = meta
        return logdet, vals, s, boost

    @staticmethod
    def _factor(ctx):
        data, vals, s = ctx.saved_tensors
        return SupernodalFactor(vals, s, None, None, ctx.meta, (vals.shape[0],), _KERNEL_OPS, data)

    @staticmethod
    def backward(ctx, glogdet, _gv, _gs, _gb):
        f = SupernodalLogdet._factor(ctx)
        return glogdet[:, None] * SelectedInverse.apply(f, f.pattern, f.data), None, None

    @staticmethod
    def jvp(ctx, ddata, _meta, _mesh):
        f = SupernodalLogdet._factor(ctx)
        return (f._sigma(f.pattern) * ddata).sum(-1), None, None, None


@dataclasses.dataclass(frozen=True)
class SupernodalFactor(DirectFactor):
    """Q = (S⁻¹L)(S⁻¹L)ᵀ per chain: L's values on the fill pattern, vals
    (B, nnzL+1) with a DUMMY slot, and the Jacobi scaling s (B, n).

    ``boost`` (B,) counts the diagonal blocks whose Cholesky broke down and
    was retried with a boosted pivot (0 in the well-conditioned case, as in
    the reference)."""

    vals: torch.Tensor
    s: torch.Tensor
    logdet_: torch.Tensor
    boost: torch.Tensor
    meta: tuple
    batch_shape: tuple
    # the steps' implementations: the kernels (plain versions on CPU tensors);
    # _PLAIN_OPS only to compare the kernels with the plain versions on the card
    _ops: dict = dataclasses.field(default_factory=lambda: _KERNEL_OPS, repr=False, compare=False)
    data: torch.Tensor = dataclasses.field(default=None, repr=False, compare=False)  # (B, nnz) factored

    @property
    def plan(self):
        return _PLAN_CACHE[self.meta]

    @property
    def n(self):
        return self.plan["n"]

    @property
    def pattern(self) -> SparsePattern:
        return self.meta[0]

    def _levels(self):
        return _device_plan(self.meta, self.vals.device)["levels"]

    # -- right-hand sides: (*batch, n) or (*batch, n, k) ↔ (B·k, n) rows -----------

    def _rows(self, b: torch.Tensor):
        n, bs = self.n, tuple(self.batch_shape)
        if b.shape[: len(bs) + 1] != bs + (n,) or b.ndim not in (len(bs) + 1, len(bs) + 2):
            raise ValueError(f"rhs of shape {tuple(b.shape)} does not match a factor of {bs} x {n}")
        k = 1 if b.ndim == len(bs) + 1 else b.shape[-1]
        B = self.vals.shape[0]
        return b.reshape(B, n, k).transpose(1, 2).reshape(B * k, n).contiguous(), k

    def _unrows(self, rows: torch.Tensor, like: torch.Tensor, k: int):
        B = self.vals.shape[0]
        return rows.reshape(B, k, self.n).transpose(1, 2).reshape(like.shape)

    def _scale_rows(self, k: int):
        return self.s if k == 1 else self.s.repeat_interleave(k, 0)

    # -- solves -----------------------------------------------------------------------

    def _forward(self, xp: torch.Tensor, k: int):
        """L y = b over the level schedule (ascending): K7 per level, K5 ELL."""
        ops = self._ops
        for lv in self._levels():
            u = _buffer(xp, xp.shape[0], lv.zf)
            ops["trsv"](self.vals, lv.group, xp, u, FORWARD, k)
            for ell in lv.fwd:
                ops["segsum"](ell, u, out=xp, alpha=-1.0, accumulate=True)
        return xp

    def _backward(self, xp: torch.Tensor, k: int):
        """Lᵀ x = z over the level schedule (descending): K7 per level."""
        ops = self._ops
        for lv in reversed(self._levels()):
            ops["trsv"](self.vals, lv.group, xp, None, BACKWARD, k)
        return xp

    def _unperm(self, xp: torch.Tensor, k: int):
        dp = _device_plan(self.meta, xp.device)
        out = xp.new_empty(xp.shape[0], self.n)
        return self._ops["segsum"](dp["unperm"], xp, y=self._scale_rows(k), out=out)

    def _solve_both(self, b: torch.Tensor) -> torch.Tensor:
        """Q x = b: K7 forward and backward over the level schedule."""
        rows, k = self._rows(b)
        dp = _device_plan(self.meta, b.device)
        xp = self._ops["segsum"](dp["perm"], rows, y=self._scale_rows(k))
        xp = self._backward(self._forward(xp, k), k)
        return self._unrows(self._unperm(xp, k), b, k)

    def solve_refined(self, Q: SparseMatrix, b: torch.Tensor, iters: int = 2) -> torch.Tensor:
        """Solve with `iters` steps of iterative refinement against the true
        matrix, on every chain: x ← x + F⁻¹(b − Qx), the residual by Q's
        matvec (K4). Recovers solve accuracy lost to float32 rounding (and,
        partially, to a pivot boost) at one sparse matvec and one pair of
        triangular solves per step."""
        x = self.solve(b)
        B, n = self.vals.shape[0], self.n
        for _ in range(iters):
            xr = x.reshape(B, n, -1)
            Qx = torch.stack([Q.matvec(xr[..., j].contiguous()) for j in range(xr.shape[-1])], -1)
            x = x + self.solve(b - Qx.reshape(x.shape))
        return x

    def forward_solve(self, b: torch.Tensor) -> torch.Tensor:
        """L x = S·b in the permuted basis (whitening), returned unpermuted to
        the original ids as the reference does (``supernodal.py:1270``)."""
        y = super().forward_solve(b)
        nb = len(self.batch_shape)
        return y.index_select(nb, _device_plan(self.meta, y.device)["inv_perm_l"])

    def _tri(self, op: int, z: torch.Tensor) -> torch.Tensor:
        """op(L) z for L = S⁻¹PᵀL' (`FactorTriangular`), rows in the original
        numbering, columns in the permuted one (z of `backward_solve`, the
        result of L⁻¹): L⁻¹ and L⁻ᵀ on K7's forward and backward modes over the
        level schedule, L z on its mode MULTIPLY with the forward ELL plans
        (K5) adding Lb·z into the rows, Lᵀ z on its mode MULTIPLY_T; the
        permutations and the scaling are K5 launches."""
        rows, k = self._rows(z)
        ops = self._ops
        dp = _device_plan(self.meta, z.device)
        if op == TRI_LINV:
            xp = ops["segsum"](dp["perm"], rows, y=self._scale_rows(k))
            return self._unrows(self._forward(xp, k)[:, : self.n], z, k)
        if op == TRI_LINVT:
            zp = torch.cat([rows, rows.new_zeros(rows.shape[0], 1)], -1)
            return self._unrows(self._unperm(self._backward(zp, k), k), z, k)
        if op == TRI_L:
            zp = torch.cat([rows, rows.new_zeros(rows.shape[0], 1)], -1)
            out = torch.zeros_like(zp)
            for lv in self._levels():
                u = _buffer(zp, zp.shape[0], lv.zf)
                ops["multiply"](self.vals, lv.group, out, zp, u, k)
                for ell in lv.fwd:
                    ops["segsum"](ell, u, out=out, alpha=1.0, accumulate=True)
            x = ops["segsum"](dp["unperm"], out, y=1.0 / self._scale_rows(k), out=out.new_empty(out.shape[0], self.n))
            return self._unrows(x, z, k)
        yp = ops["segsum"](dp["perm"], rows, y=1.0 / self._scale_rows(k))
        out = torch.zeros_like(yp)
        for lv in self._levels():
            ops["multiply"](self.vals, lv.group, out, yp, None, k, transpose=True)
        return self._unrows(out[:, : self.n], z, k)

    def _fill_rows_cols(self, device):
        """(row, col) of every position of L's pattern in the permuted basis
        (the DUMMY slot reads row and column n, a zero), int64 on `device`."""
        key = (self.meta, "fill", str(device))
        got = _SELINV_CACHE.get(key)
        if got is None:
            plan = self.plan
            n, keyv = plan["n"], np.asarray(plan["entry_key"], np.int64)
            got = _SELINV_CACHE[key] = tuple(torch.as_tensor(np.concatenate([a, [n]]), device=device)
                                             for a in (keyv % n, keyv // n))
        return got

    def _factor_adjoint(self, U: torch.Tensor, V: torch.Tensor) -> tuple:
        """data̅ for L̄ = P_L(U Vᵀ): L̄' = P_L((P S⁻¹U) Vᵀ) gathered onto the fill
        (torch products, a few right-hand sides at a time), the reverse sweep
        level by level, descending (K25, A from K8's first entry), then
        s_r s_c Q̄' at the pattern's entries (K5), each entry of a symmetric pair
        given half of its lower position's."""
        ops = self._ops
        B, n = self.vals.shape[0], self.n
        Ur, Vr = U.reshape(B, n, -1), V.reshape(B, n, -1)
        k = Ur.shape[-1]
        perm = _device_plan(self.meta, U.device)["perm_l"]
        Up = torch.cat([(Ur / self.s[..., None]).index_select(1, perm), Ur.new_zeros(B, 1, k)], 1)
        Vp = torch.cat([Vr, Vr.new_zeros(B, 1, k)], 1)
        r, c = self._fill_rows_cols(U.device)
        g = torch.zeros_like(self.vals)
        step = max(1, (1 << 25) // max(1, B * r.shape[0]))
        for j in range(0, k, step):
            g += (Up[:, r, j: j + step] * Vp[:, c, j: j + step]).sum(-1)
        pre = _prep_vals(self.vals, self.meta, ops)
        for lv in reversed(self._levels()):
            for cl in lv.classes:
                ops["panel_adjoint"](self.vals, pre, g, cl)
        w = symmetric_weights(self.pattern, g.device, g.dtype)
        return (_selinv_data(self.vals, self.s, self.pattern, self.meta, ops, sig=g) * w,)

    def _factor_tangent(self, dinputs) -> "SupernodalFactor":
        """The factor whose values are L̇' (`_factor_tangent`: K5, K20)."""
        pre = _prep_vals(self.vals, self.meta, self._ops)
        dvals = _factor_tangent(self.vals, self.s, pre, self._tangent_data(dinputs), self.pattern, self.meta,
                                self._ops)
        return dataclasses.replace(self, vals=dvals)

    # -- statistics -----------------------------------------------------------------

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def _sigma_vals(self) -> torch.Tensor:
        return _sigma_vals(self.vals, self.meta, self._ops)

    def _sigma(self, where) -> torch.Tensor:
        """Σ at `where`'s entries (an int n: the diagonal), (B, m): K8, then K5."""
        return _selinv_data(self.vals, self.s, where, self.meta, self._ops)

    def _sigma_tangent(self, t: torch.Tensor, p_in, p_out) -> torch.Tensor:
        """−Σ·sym(T)·Σ at p_out's entries for T given by t (B, m) on p_in's (K5, K8, K20, K21)."""
        dsig = _tangent_sigma(self.vals, self.s, t, p_in, self.meta, self._ops)
        return _selinv_data(self.vals, self.s, p_out, self.meta, self._ops, sig=dsig)


def supernodal_factorize(Q: SparseMatrix, max_width: int = 2048, ordering: str = "auto", mesh=None
                         ) -> SupernodalFactor:
    """Factorize Q (SPD, symmetric pattern; data (nnz,) or (B, nnz)). With
    `mesh` (a ``torch.distributed.device_mesh.DeviceMesh``), the scan levels'
    panel work is split over the ranks of its first dimension; every rank
    passes the same Q and gets the same factor, equal to the one-rank path's."""
    return _factorize(Q, max_width, ordering, _KERNEL_OPS, mesh)


def _factorize(Q: SparseMatrix, max_width: int, ordering: str, ops: dict, mesh=None) -> SupernodalFactor:
    """`supernodal_factorize` on the kernels, or, with ops=_PLAIN_OPS, on the
    plain versions whatever the device and with no gradient (to compare the
    kernels with them on the card)."""
    if not Q.pattern.is_symmetric:
        raise ValueError("supernodal backend requires a symmetric pattern")
    if Q.data.ndim > 2:
        raise ValueError("data must be (nnz,) or (B, nnz)")
    supernodal_plan(Q.pattern, max_width, ordering)  # ensure cached
    meta = (Q.pattern, max_width, ordering)
    batch = tuple(Q.data.shape[:-1])
    data = Q.data.reshape(-1, Q.nnz)
    if ops is _KERNEL_OPS:
        logdet, vals, s, boost = SupernodalLogdet.apply(data, meta, mesh)
    else:
        with torch.no_grad():
            vals, s, logdet, boost = _factor_values(data, meta, ops, mesh)
    return SupernodalFactor(vals, s, logdet.reshape(batch), boost, meta, batch, ops, data)
