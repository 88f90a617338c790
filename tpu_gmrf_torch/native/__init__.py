"""Native (C++) symbolic core with a pure-NumPy fallback.

Counterpart of ``tpu_gmrf.native``, copied so that the port never imports
the JAX package: ``symbolic.cpp`` is the reference's source, unchanged. The
library is built with g++ at first use into ``tpu_gmrf_torch/_build/``
under a name keyed by a hash of the source, so a checkout builds its own.

The C++ library (`symbolic.cpp`) implements the host-side symbolic half of
the supernodal sparse Cholesky: AMD fill-reducing ordering, elimination
tree, postorder, column counts, L fill pattern, and supernode partition —
the role CHOLMOD's symbolic analysis plays in the reference
(reference src/workspace/backend.jl:24-182). It is compiled on first use
with g++ and loaded through ctypes; if no toolchain is available the
NumPy fallback below produces identical output (slower, same API).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = [
    "amd_order",
    "nd_order",
    "etree",
    "postorder",
    "col_counts",
    "symbolic_fill",
    "supernode_partition",
    "native_available",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()
_lib = None
_lib_tried = False


def _build_library() -> str | None:
    src = os.path.join(_HERE, "symbolic.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libtpugmrf_symbolic_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = tempfile.mktemp(suffix=".so", dir=_BUILD_DIR)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        return None


def _load():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        path = _build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.tpugmrf_amd.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
        lib.tpugmrf_nd.argtypes = [
            ctypes.c_int32, i32p, i32p, ctypes.c_int32, i32p,
        ]
        lib.tpugmrf_nd.restype = ctypes.c_int32
        lib.tpugmrf_etree.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
        lib.tpugmrf_postorder.argtypes = [ctypes.c_int32, i32p, i32p]
        lib.tpugmrf_colcounts.argtypes = [ctypes.c_int32, i32p, i32p, i32p, i32p]
        lib.tpugmrf_symbolic_fill.argtypes = [
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
        ]
        lib.tpugmrf_supernodes.argtypes = [
            ctypes.c_int32, i32p, i32p, ctypes.c_int32, i32p,
        ]
        for f in (
            lib.tpugmrf_amd,
            lib.tpugmrf_etree,
            lib.tpugmrf_postorder,
            lib.tpugmrf_colcounts,
            lib.tpugmrf_symbolic_fill,
            lib.tpugmrf_supernodes,
        ):
            f.restype = ctypes.c_int32
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_csr(n, indptr, indices):
    indptr = _i32(indptr)
    indices = _i32(indices)
    if indptr.shape != (n + 1,):
        raise ValueError("indptr must have length n+1")
    return indptr, indices


# ---------------------------------------------------------------------------
# Public API. Inputs: CSR (indptr, indices) of the FULL symmetric pattern.
# ---------------------------------------------------------------------------


def amd_order(n: int, indptr, indices) -> np.ndarray:
    """Approximate-minimum-degree permutation: perm[k] = old index of new k."""
    indptr, indices = _check_csr(n, indptr, indices)
    lib = _load()
    if lib is not None:
        perm = np.empty(n, dtype=np.int32)
        rc = lib.tpugmrf_amd(n, _ptr(indptr), _ptr(indices), _ptr(perm))
        if rc == 0:
            return perm
    return _amd_python(n, indptr, indices)


def nd_order(n: int, indptr, indices, leaf: int = 96) -> np.ndarray:
    """Nested-dissection permutation (BFS level-set bisection, AMD leaves):
    perm[k] = old index of new k. Falls back to AMD when no native library
    is available (same contract: a fill-reducing permutation)."""
    indptr, indices = _check_csr(n, indptr, indices)
    lib = _load()
    if lib is not None:
        perm = np.empty(n, dtype=np.int32)
        rc = lib.tpugmrf_nd(n, _ptr(indptr), _ptr(indices), int(leaf), _ptr(perm))
        if rc == 0:
            return perm
    return _nd_python(n, indptr, indices, leaf)


def etree(n: int, indptr, indices) -> np.ndarray:
    indptr, indices = _check_csr(n, indptr, indices)
    lib = _load()
    parent = np.empty(n, dtype=np.int32)
    if lib is not None:
        lib.tpugmrf_etree(n, _ptr(indptr), _ptr(indices), _ptr(parent))
        return parent
    return _etree_python(n, indptr, indices)


def postorder(parent: np.ndarray) -> np.ndarray:
    parent = _i32(parent)
    n = len(parent)
    lib = _load()
    if lib is not None:
        post = np.empty(n, dtype=np.int32)
        rc = lib.tpugmrf_postorder(n, _ptr(parent), _ptr(post))
        if rc == 0:
            return post
    return _postorder_python(parent)


def col_counts(n: int, indptr, indices, parent) -> np.ndarray:
    indptr, indices = _check_csr(n, indptr, indices)
    parent = _i32(parent)
    lib = _load()
    if lib is not None:
        counts = np.empty(n, dtype=np.int32)
        lib.tpugmrf_colcounts(
            n, _ptr(indptr), _ptr(indices), _ptr(parent), _ptr(counts)
        )
        return counts
    return _colcounts_python(n, indptr, indices, parent)


def symbolic_fill(n: int, indptr, indices, parent, counts):
    """CSC row structure of L: returns (lp: (n+1,), li: (nnzL,)), rows sorted."""
    indptr, indices = _check_csr(n, indptr, indices)
    parent = _i32(parent)
    counts = _i32(counts)
    nnz = int(counts.sum())
    lib = _load()
    if lib is not None:
        lp = np.empty(n + 1, dtype=np.int32)
        li = np.empty(max(nnz, 1), dtype=np.int32)
        lib.tpugmrf_symbolic_fill(
            n, _ptr(indptr), _ptr(indices), _ptr(parent), _ptr(counts),
            _ptr(lp), _ptr(li),
        )
        return lp, li[:nnz]
    return _fill_python(n, indptr, indices, parent, counts)


def supernode_partition(parent, counts, max_width: int = 64) -> np.ndarray:
    """snode[j] = supernode id of column j (contiguous, nondecreasing)."""
    parent = _i32(parent)
    counts = _i32(counts)
    n = len(parent)
    lib = _load()
    if lib is not None:
        snode = np.empty(n, dtype=np.int32)
        lib.tpugmrf_supernodes(
            n, _ptr(parent), _ptr(counts), int(max_width), _ptr(snode)
        )
        return snode
    return _supernodes_python(parent, counts, max_width)


# ---------------------------------------------------------------------------
# Pure-NumPy fallbacks (identical semantics).
# ---------------------------------------------------------------------------


def _amd_python(n, indptr, indices):
    # Fallback ordering: reverse Cuthill-McKee (scipy) — not minimum degree,
    # but a valid fill-reducing permutation with the same contract.
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = sp.csr_matrix(
        (np.ones(len(indices), dtype=np.int8), indices, indptr), shape=(n, n)
    )
    return np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True), dtype=np.int32)


def _nd_python(n, indptr, indices, leaf):
    """Recursive BFS-bisection nested dissection (NumPy/scipy), matching the
    native routine's contract. Used only when the C++ library is missing."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order

    S = sp.csr_matrix(
        (np.ones(len(indices), dtype=np.int8), indices, indptr), shape=(n, n)
    )
    out = np.empty(n, dtype=np.int32)
    pos = [0]

    def emit(verts):
        out[pos[0] : pos[0] + len(verts)] = verts
        pos[0] += len(verts)

    def levels_from(sub, start_local):
        order, _ = breadth_first_order(sub, start_local, directed=False)
        lev = np.full(sub.shape[0], -1, dtype=np.int64)
        lev[start_local] = 0
        # BFS by sparse matvec frontier expansion
        frontier = np.zeros(sub.shape[0], bool)
        frontier[start_local] = True
        seen = frontier.copy()
        d = 0
        while frontier.any():
            d += 1
            nxt = (sub @ frontier.astype(np.int8)) > 0
            nxt &= ~seen
            lev[nxt] = d
            seen |= nxt
            frontier = nxt
        return lev

    def rec(verts):
        m = len(verts)
        if m <= max(leaf, 4):
            sub = S[verts][:, verts]
            emit(verts[amd_order(m, sub.indptr, sub.indices)])
            return
        sub = S[verts][:, verts].tocsr()
        lev = levels_from(sub, 0)
        if (lev >= 0).all():
            far = int(np.argmax(lev))
            lev = levels_from(sub, far)
        lev[lev < 0] = lev.max() + 1  # disconnected pieces at the far end
        maxlev = int(lev.max())
        if maxlev < 2:
            sub2 = S[verts][:, verts]
            emit(verts[amd_order(m, sub2.indptr, sub2.indices)])
            return
        csum = np.cumsum(np.bincount(lev, minlength=maxlev + 1))
        cut = int(np.searchsorted(csum, (m + 1) // 2))
        cut = min(max(cut, 1), maxlev - 1)
        amask = lev < cut
        bmask = lev > cut
        smask = lev == cut
        # shrink separator: cut-level vertices with no cut+1 neighbour go to A
        nb_next = (sub @ (lev == cut + 1).astype(np.int8)) > 0
        amask |= smask & ~nb_next
        smask &= nb_next
        if not amask.any() or not bmask.any():
            sub2 = S[verts][:, verts]
            emit(verts[amd_order(m, sub2.indptr, sub2.indices)])
            return
        rec(verts[amask])
        rec(verts[bmask])
        emit(verts[smask])

    rec(np.arange(n, dtype=np.int32))
    return out


def _etree_python(n, indptr, indices):
    parent = np.full(n, -1, dtype=np.int32)
    ancestor = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            k = indices[p]
            if k >= i:
                continue
            r = k
            while r != -1 and r != i:
                nxt = ancestor[r]
                ancestor[r] = i
                if nxt == -1:
                    parent[r] = i
                r = nxt
    return parent


def _postorder_python(parent):
    n = len(parent)
    children = [[] for _ in range(n)]
    for j in range(n):
        if parent[j] != -1:
            children[parent[j]].append(j)
    post = np.empty(n, dtype=np.int32)
    top = 0
    for root in range(n):
        if parent[root] != -1:
            continue
        stack = [(root, iter(children[root]))]
        while stack:
            node, it = stack[-1]
            child = next(it, None)
            if child is None:
                stack.pop()
                post[top] = node
                top += 1
            else:
                stack.append((child, iter(children[child])))
    return post


def _colcounts_python(n, indptr, indices, parent):
    counts = np.ones(n, dtype=np.int32)
    mark = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            k = indices[p]
            if k >= i:
                continue
            j = k
            while j != -1 and j < i and mark[j] != i:
                counts[j] += 1
                mark[j] = i
                j = parent[j]
    return counts


def _fill_python(n, indptr, indices, parent, counts):
    lp = np.zeros(n + 1, dtype=np.int32)
    lp[1:] = np.cumsum(counts)
    li = np.empty(int(lp[-1]), dtype=np.int32)
    fill = lp[:-1].copy()
    for j in range(n):
        li[fill[j]] = j
        fill[j] += 1
    mark = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            k = indices[p]
            if k >= i:
                continue
            j = k
            while j != -1 and j < i and mark[j] != i:
                li[fill[j]] = i
                fill[j] += 1
                mark[j] = i
                j = parent[j]
    return lp, li


def _supernodes_python(parent, counts, max_width):
    n = len(parent)
    snode = np.empty(n, dtype=np.int32)
    if n == 0:
        return snode
    snode[0] = 0
    cur = 0
    width = 1
    for j in range(1, n):
        if parent[j - 1] == j and counts[j] == counts[j - 1] - 1 and width < max_width:
            snode[j] = cur
            width += 1
        else:
            cur += 1
            snode[j] = cur
            width = 1
    return snode
