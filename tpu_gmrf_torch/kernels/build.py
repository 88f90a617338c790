"""Build and load the hand-written CUDA kernels (``tpu_gmrf_torch/csrc``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``tpu_gmrf_torch/_build/``, under a file name
keyed by a hash of the sources and flags, so a checkout builds its own
library and an edited source is rebuilt. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "library", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    # a, c, d, e, logdet, B, n, then the scan's shape (warps per chain, rows per thread), stream
    "tg_tridiag_factor": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # d, e, b, out, B, n, k, mode, the scan's shape, stream
    "tg_tridiag_solve": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # d, e, zdiag, zoff, B, n, the scan's shape, stream
    "tg_tridiag_selinv": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # d, e, zdiag, da, dc, dzdiag, dzoff, B, n, the scan's shape, stream
    "tg_tridiag_selinv_tangent": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # row_ptr, col, data, dstride, x, y, quad, B, n_r, n_c, tiled, partial, stream
    "tg_csr_spmv": [_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # plan (the address of its argument block, kernels/segsum.py), out, ostride, x, xstride, y, ystride, z,
    # zstride, alpha, accumulate, B, stream
    "tg_gather_segsum": [_P, _P, _L, _P, _L, _P, _L, _P, _L, _D, _I, _I, _P],
    # vals, vstride, s, nls, nlsstride, a, astride, tperm, diag, rows, cols, src, dst, n, m, B, stream
    "tg_fct_init": [_P, _L, _P, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # vals, vstride, batch table (int64, 10 per class batch), batches, supernodes, widest W, dummy, u, ustride,
    # logpiv, n, boost, work (float64; the cluster path only), flags (int; the same), cluster size (0: one block),
    # B, stream
    "tg_sn_panel": [_P, _L, _P, _I, _I, _I, _I, _P, _L, _P, _I, _P, _P, _P, _I, _I, _P],
    "tg_sn_panel_fit": [_I, ctypes.POINTER(_I)],
    # vals, vstride, batch table, batches, supernodes, widest W, dummy, x, xstride, k, u, ustride, mode,
    # B (chains), z (mode 2), column tile (8 or 64), stream
    "tg_sn_trsv": [_P, _L, _P, _I, _I, _I, _I, _P, _L, _I, _P, _L, _I, _I, _P, _I, _P],
    # vals, vstride, pre, pstride, panel_idx, P, W, M, dummy, work (float64; W > 64 only), B, stream
    "tg_sn_takahashi_prep": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _P, _I, _P],
    # pre, pstride, sig, sstride, panel_idx, schur_idx, P, W, M, dummy, cluster size (0: the two product launches),
    # their blocks per supernode t1, t2, B, stream
    "tg_sn_takahashi": [_P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # vals, vstride, pre, dvals, pstride (pre's and dvals'), du, ustride, ubase, panel_idx, P, W, M, dummy,
    # work (float64, `tangent_work` per supernode and chain), B, cluster size (blocks per supernode and chain),
    # stream
    "tg_sn_panel_tangent": [_P, _L, _P, _P, _L, _P, _L, _L, _P, _I, _I, _I, _I, _P, _I, _I, _P],
    # vals, vstride, pre, dvals, sig, dsig, pstride (all but vals'), panel_idx, schur_idx, P, W, M, dummy, work, B,
    # cluster size, stream
    "tg_sn_takahashi_tangent": [_P, _L, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P],
    # cluster size, which (0: K20, 1: K21, 2: K25), out: how many such clusters the card holds
    "tg_sn_tangent_fit": [_I, _I, ctypes.POINTER(_I)],
    # vals, vstride, pre, gvals, pstride (pre's and gvals'), panel_idx, schur_idx, P, W, M, dummy, work (float64,
    # `tangent_work` per supernode and chain), B, cluster size, stream
    "tg_sn_panel_adjoint": [_P, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P],
    # d, e, d̄, ē, ā, c̄, B, n, the scan's shape, stream
    "tg_tridiag_factor_adjoint": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # P, pre, G, pstride (pre's and G's, per chain), K, s, work (float64, `bt_tangent_work` per chain), B,
    # cluster size, stream
    "tg_bt_factor_adjoint": [_P, _P, _P, _L, _I, _I, _P, _I, _I, _P],
    "tg_bt_factor_adjoint_fit": [_I, ctypes.POINTER(_I)],
    # P, K, s, n, perm, x, y, kk, B, nv, chunks, work, stream: bt_sqrt's transpose mode
    "tg_bt_sqrt_t": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # P, pre, dP, pstride (pre's and dP's, per chain), K, s, work (float64, `bt_tangent_work` per chain), B,
    # cluster size, stream
    "tg_bt_factor_tangent": [_P, _P, _P, _L, _I, _I, _P, _I, _I, _P],
    "tg_bt_factor_tangent_fit": [_I, ctypes.POINTER(_I)],
    # data, dstride, rows, cols, tperm, diag_pos, nnz, n, L, s, level, logdet, flags (3 per chain),
    # work (inverted diagonal tiles), cluster size, B, stream
    "tg_dense_chol": [_P, _L, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # cluster size, out: how many such clusters of K9's factorization the card holds
    "tg_dense_chol_fit": [_I, ctypes.POINTER(_I)],
    # L, s, Dinv (K9's inverted diagonal tiles), b, out, n, k, mode, cluster size, B, stream
    "tg_dense_trsv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # cluster size, wide (64-column groups), out: how many such clusters of K10 the card holds
    "tg_dense_trsv_fit": [_I, _I, ctypes.POINTER(_I)],
    # L, s, Dinv, X (workspace), rows, cols, m, n, out, cluster size, B, stream
    "tg_dense_selinv": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P],
    # data, dstride, src, dst, ntab, tperm, P, K, s, ws, dom, boost, logdet, flags, cluster size, B, stream
    "tg_bt_factor": [_P, _L, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # cluster size, out: how many such clusters of K11's factorization the card holds
    "tg_bt_factor_fit": [_I, ctypes.POINTER(_I)],
    # P, K, s, n, perm, b, out, k, mode, B, work (block layout, scratch), stream
    "tg_bt_trsv": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    # D, E, P, K, s, logdet, flags, cluster size, B, stream
    "tg_bt_factor_blocks": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P],
    # P, K, s, b, out, k, B, work (one block row of scratch), stream
    "tg_bt_trsv_blocks": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    # alpha, beta, gamma, r, P, ns, k, Lr, factored, s, work, bad (int flag), logdet, stream
    "tg_spike_reduced": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    # diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, n, perm, x, y, kk, B, then the split (nv, chunks,
    # strips, cluster, parts, cpl, threads), lower, upper, work, stream
    "tg_bt_matvec": [_P, _L, _L, _P, _L, _L, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P, _P],
    # blocks, block_stride, rowptr, bcols, tperm (null: forward), bs, nb, n, x, y, R, then the split (warps a CTA,
    # warps a block row, blocks a stage, ring depth), stream
    "tg_bsr_spmm": [_P, _L, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # brows, bcols, nblocks, bs, n, g, x, R, per_chain, dblocks, stream
    "tg_bsr_outer": [_P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P],
    # theta, entry_pos, count, cap, jitter, out, work and flags (the cluster path; else null), cluster size, B,
    # stream
    "tg_kl_columns": [_P, _P, _P, _I, _D, _P, _P, _P, _I, _I, _P],
    # cluster size, out: how many such clusters of K16's cluster path the card holds
    "tg_kl_fit": [_I, ctypes.POINTER(_I)],
    # C, n, idx, ptr, out_off, sign, out, goff, gf, gperm, order, the classes' sizes (global, shared, tile, warp),
    # the shared class's largest set, stream
    "tg_block_inv": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet); return the .so path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libtpu_gmrf_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))
    tmp = out.with_name(f"{tag}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.tg_error_string.argtypes = [ctypes.c_int]
        lib.tg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, name: str, context: str = "") -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().tg_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg}){context}")
