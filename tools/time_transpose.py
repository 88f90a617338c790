"""Time the two transpose products Lᵀz of tpu_gmrf_torch from the source tree
given as the first argument: K7's mode 3 (`sn_multiply_t` over the
supernodal factor's schedule) and K13's transpose mode (`bt_sqrt_t`, on the
banded factor), at chip_smoke.py phase 3h's shape
(the n=5741 Matérn posterior, 4 chains) with k = 16 and k = 1 right-hand
sides per chain, in float32 and float64, beside their library yardstick (one
`torch.matmul` of the densified factor's transpose and the permuted rows);
needs a CUDA device.

To compare two trees on one card, unpack the other tree (``git archive``)
into a git-ignored directory and run both in turns in one command:

    for t in _checkout/parent . . _checkout/parent; do python3 tools/time_transpose.py $t; done

Each run builds that tree's kernels and prints, per product, the time of a
call by CUDA events (chip_smoke.cuda_ms: 20 calls after a warm-up, host gaps
included), the device time of its kernels per call from a torch.profiler
trace (no host gaps), the library call's time, and the card's name and power
limit. A tree from before these wrappers (the products as `sn_multiply` and
`bt_sqrt` with `transpose`, K7's level by level) is called as its own solver
calls it; its script has no densified banded factor, so its K13 line has no
library time (the same matmul as the other tree's).
"""

import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the tree's own script: its models and timers)
import tpu_gmrf_torch as tg  # noqa: E402
from tpu_gmrf_torch import kernels  # noqa: E402
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.solvers import banded as bd  # noqa: E402
from tpu_gmrf_torch.solvers import supernodal as sn  # noqa: E402

K7_NAMES = ("sn_trsv_kernel", "sn_multiply_t_kernel")
K13_NAMES = ("bt_rows_in", "bt_sqrt_t_kernel", "bt_rows_out")


def line(label, run, names, library):
    ms = cs.cuda_ms(run)
    dev_ms = cs.kernel_device_ms(lambda: [run() for _ in range(cs.REPS)], names, cs.REPS)
    lib = f"{cs.cuda_ms(library):.4f} ms" if library else "not timed"
    print(f"{os.path.relpath(root)}: {label}: {ms:.4f} ms a call, device {dev_ms:.4f} ms, library {lib}", flush=True)


def k7_product(f, groups):
    """Lᵀz on K7's mode 3 as the tree's solver makes it: one call over the schedule, or one per level."""
    def one(g, out, yp, k):
        if hasattr(kernels, "sn_multiply_t"):
            return kernels.sn_multiply_t(f.vals, g, out, yp, k)
        return kernels.sn_multiply(f.vals, g, out, yp, None, k, transpose=True)

    def run(yp, k):
        out = torch.zeros_like(yp)
        for g in groups:
            one(g, out, yp, k)
        return out

    return run


def k13_product(P, t):
    if hasattr(kernels, "bt_sqrt_t"):
        return lambda z, k: kernels.bt_sqrt_t(P, t, z, k)
    return lambda z, k: kernels.bt_sqrt(P, t, z, k, True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_transpose: no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.library()
    dev = torch.device("cuda")
    model = cs.spatial_model(cs.SP_GRID)
    B, n = cs.SP_CHAINS, model.n
    rng = np.random.default_rng(31)
    U64 = rng.normal(size=(B, n, 16))
    print(f"{os.path.relpath(root)} on {cs.card_line()}", flush=True)
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        U = torch.tensor(U64, dtype=dtype, device=dev)
        f = tg.factorize(cs.random_posterior(model, B, dtype, dev, seed=26), tg.SolverSpec(kind="supernodal"))
        dp = sn._device_plan(f.meta, dev)
        groups = [dp["schedule"]] if "schedule" in dp else [lv.group for lv in dp["levels"]]
        L, _, _ = cs.dense_factor(f.vals, f.meta)
        fb = tg.factorize(cs.random_posterior(model, B, dtype, dev, seed=24), tg.SolverSpec(kind="banded"))
        t = bd._TABLES[fb.meta]
        dense = getattr(cs, "banded_factor_dense", None)
        Lb = dense(fb.P) if dense else None
        perm = t.on(dev)["perm_l"]
        k7, k13 = k7_product(f, groups), k13_product(fb.P, t)
        for k in (16, 1):
            rows, _ = f._rows(U[..., :k])
            yp = kernels.gather_segsum(dp["perm"], rows, y=1.0 / f._scale_rows(k))
            zr = yp[:, :n].reshape(B, k, -1).transpose(1, 2)
            line(f"K7 mode 3 {name} k={k} ({len(groups)} launches)", lambda yp=yp, k=k: k7(yp, k), K7_NAMES,
                 lambda zr=zr: L.mT @ zr)
            brow = U[..., :k].transpose(1, 2).reshape(B * k, -1).contiguous()
            zb = U.new_zeros(B, fb.P.shape[1] * fb.P.shape[3], k)
            zb[:, :n] = U[:, perm, :k]
            line(f"K13 transpose {name} k={k}", lambda brow=brow, k=k: k13(brow, k), K13_NAMES,
                 (lambda zb=zb: Lb.mT @ zb) if dense else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
