"""Wrapper of K17 `block_inv` (``csrc/block_inv.cu``) and its plain version.

`BlockSets` is static host data: sets of row indices of a dense n × n
matrix C (flat ``idx`` with offsets ``ptr``), a sign per set, and each
set's offset into a flat output of Σ size² values. `block_inv` writes
``sign_s · inv(C[s, s])`` row-major at each set's offset
(``tpu_gmrf/graphical_lasso.py:150-151``, the reference's batched
``jnp.linalg.inv`` per size bucket). The inverse is Gauss-Jordan with
partial pivoting, not a Cholesky inverse: a block need not be positive
definite.

The kernel takes the sets largest first, in classes by size
(`BlockSets.on` builds the plan once per device and dtype): warp (≤ 32
rows, a warp per set), tile (≤ 96, a block of threads per set holding it in
registers) and global (beyond shared memory) in one launch; shared (up to
`block_inv_smem_max`, f64 169, f32 239) in a launch of its own, its shared
memory sized by its own largest set.

A CPU tensor takes the plain version (the same pivoted Gauss-Jordan in
batched torch ops, over the sets padded with decoupled identity rows to the
largest size); a CUDA tensor launches the kernel or raises. Both round every
operation once, in the same order. ``block_inv.launches`` counts launches
(one or two a call).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .tridiag import _fn, _on_cuda, _stream

__all__ = ["BlockSets", "block_inv", "block_inv_plain", "block_inv_smem_max"]

SMEM_OPTIN = 232448  # bytes of shared memory one block may use on an H100 (227 KB, opt-in)
_STATIC_SMEM = 8 * 32 + 4 * 32 + 64  # the shared class's static shared memory (pivot search)
WARP_MAX, TILE_MAX = 32, 96  # the warp and tile classes' largest sets (csrc/block_inv.cu kWarpMax, 16 kRT)


def block_inv_smem_max(dtype: torch.dtype) -> int:
    """The largest set a launch inverts in shared memory (f64: 169, f32: 239)."""
    el = torch.finfo(dtype).bits // 8
    s = 1
    while el * ((s + 1) ** 2 + (s + 1)) + 4 * (s + 1) + _STATIC_SMEM <= SMEM_OPTIN:
        s += 1
    return s


class BlockSets:
    """Sets (lists of int index arrays) with one sign each, as int tables."""

    def __init__(self, sets, signs):
        sizes = np.array([len(s) for s in sets], np.int64)
        if len(sets) != len(signs) or (sizes < 1).any():
            raise ValueError("BlockSets: one sign per non-empty set")
        self.sizes = sizes
        self.idx = np.concatenate([np.asarray(s, np.int64) for s in sets]).astype(np.int32) if len(sets) \
            else np.zeros(0, np.int32)
        self.ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.out_off = np.concatenate([[0], np.cumsum(sizes**2)]).astype(np.int64)
        self.signs = np.asarray(signs, np.float64)
        self.total = int(self.out_off[-1])
        self._dev: dict = {}

    def __len__(self):
        return len(self.sizes)

    def plan(self, dtype) -> dict:
        """The launch plan: `order`, the sets largest first (ties in set order), cut into the classes
        global, shared, tile and warp (`counts`, in that order); `smem_s`, the shared class's largest set;
        `goff`, each global set's offset into the workspace (-1 for the others) and `gtotal` its size."""
        smax = block_inv_smem_max(dtype)
        order = np.argsort(-self.sizes, kind="stable")
        s = self.sizes[order]
        bounds = (np.inf, smax, TILE_MAX, WARP_MAX, 0)  # class c holds the sets of bounds[c+1] < s <= bounds[c]
        counts = [int(((s > lo) & (s <= hi)).sum()) for hi, lo in zip(bounds, bounds[1:])]
        glob = self.sizes > smax
        goff = np.where(glob, np.cumsum(np.where(glob, self.sizes, 0)) - self.sizes, -1)
        return dict(order=order, counts=counts, smem_s=int(s[counts[0]]) if counts[1] else 0, goff=goff,
                    gtotal=int(self.sizes[glob].sum()))

    def on(self, device, dtype) -> dict:
        key = (str(device), dtype)
        t = self._dev.get(key)
        if t is None:
            p = self.plan(dtype)
            i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
            i64 = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
            t = dict(idx=i32(self.idx), ptr=i64(self.ptr), out_off=i64(self.out_off), goff=i64(p["goff"]),
                     order=i32(p["order"]), sign=torch.as_tensor(self.signs, dtype=dtype, device=device),
                     counts=p["counts"], smem_s=p["smem_s"], gtotal=p["gtotal"])
            self._dev[key] = t
        return t


def block_inv_plain(C: torch.Tensor, sets: BlockSets) -> torch.Tensor:
    """K17's function in batched torch ops, operation for operation as the kernel."""
    dev, B = C.device, len(sets)
    cap = int(sets.sizes.max(initial=1))
    sizes = torch.as_tensor(sets.sizes, device=dev)
    ar = torch.arange(cap, device=dev)
    valid = ar < sizes[:, None]
    rows = torch.as_tensor(sets.ptr[:-1], device=dev)[:, None] + torch.where(valid, ar, 0)
    idx = torch.as_tensor(sets.idx, dtype=torch.long, device=dev)[rows]
    pair = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(cap, dtype=C.dtype, device=dev).expand(B, cap, cap)
    A = torch.where(pair, C[idx[:, :, None], idx[:, None, :]], eye).contiguous()
    b_ar = torch.arange(B, device=dev)
    perm = torch.empty(B, cap, dtype=torch.long, device=dev)
    for k in range(cap):
        p = torch.argmax(A[:, k:, k].abs(), dim=1) + k
        perm[:, k] = p
        row_k, row_p = A[b_ar, k].clone(), A[b_ar, p].clone()
        A[b_ar, p] = row_k
        A[b_ar, k] = row_p
        f = A[:, :, k].clone()
        row = A[:, k, :].clone()
        row[:, k] = 1.0
        row = row / f[:, k:k + 1]
        A[:, :, k] = 0.0
        A = A - f[:, :, None] * row[:, None, :]
        A[:, k, :] = row
    for k in range(cap - 1, -1, -1):
        p = perm[:, k]
        col_k, col_p = A[b_ar, :, k].clone(), A[b_ar, :, p].clone()
        A[b_ar, :, p] = col_k
        A[b_ar, :, k] = col_p
    A = torch.as_tensor(sets.signs, dtype=C.dtype, device=dev)[:, None, None] * A
    return A[pair]


def block_inv(C: torch.Tensor, sets: BlockSets) -> torch.Tensor:
    """K17: the flat (total,) buffer of sign_s · inv(C[s, s]), row-major per
    set at its offset, for a dense (n, n) C (float32/float64)."""
    if C.ndim != 2 or C.shape[0] != C.shape[1]:
        raise ValueError(f"block_inv: C must be (n, n), got {tuple(C.shape)}")
    C = C.contiguous()
    if not _on_cuda("block_inv", C):
        return block_inv_plain(C, sets)
    t = sets.on(C.device, C.dtype)
    out = C.new_empty(sets.total)
    gf = C.new_empty(max(t["gtotal"], 1))
    gperm = torch.empty(max(t["gtotal"], 1), dtype=torch.int32, device=C.device)
    counts = t["counts"]
    code = _fn("tg_block_inv", C.dtype)(
        C.data_ptr(), C.shape[0], t["idx"].data_ptr(), t["ptr"].data_ptr(), t["out_off"].data_ptr(),
        t["sign"].data_ptr(), out.data_ptr(), t["goff"].data_ptr(), gf.data_ptr(), gperm.data_ptr(),
        t["order"].data_ptr(), *counts, t["smem_s"], _stream(C),
    )
    build.check(code, "block_inv", f" at {len(sets)} sets of size <= {int(sets.sizes.max(initial=0))} "
                f"(classes global, shared, tile, warp: {counts}) {C.dtype}")
    block_inv.launches += (counts[1] > 0) + (counts[0] + counts[2] + counts[3] > 0)
    return out


block_inv.launches = 0
