"""Time K9 `dense_chol` and K16 `kl_columns` of tpu_gmrf_torch from the source
tree given as the first argument; needs a CUDA device.

The inputs are this checkout's (chip_smoke.py beside this script), the
kernels the given tree's, so two trees are timed on the same inputs. To
compare two trees on one card, unpack the other tree (``git archive``) into a
git-ignored directory and run both in turns, in one command:

    for t in _checkout/parent . . _checkout/parent; do python3 tools/time_dense_kl.py $t; done

K9 at phase 3c's shape (the g=16 posterior, B=8, n=450) and at B=1 on the
lattices of n=900 and n=1000 (the dense backend's shapes of phases 15 and
16); K16 on example 09's n=10,000 buckets at ρ=6 and on the synthetic cap-256
bucket; float64 and float32. Each time is the mean of 20 launches by CUDA
events after a warm-up (chip_smoke.py's cuda_ms); one line per shape, with
the card's name and power limit.
"""

import importlib.util
import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_gmrf_torch import kernels  # noqa: E402
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.solvers import dense as td  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "smoke_inputs", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_dense_kl: no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.library()
    dev, card, tree = torch.device("cuda"), cs.card_line(), os.path.relpath(root)
    dn = cs.spatial_model(cs.DN_GRID)
    kp = cs.kl_problem(cs.KL_GRID)
    nnz = kp["pats"][cs.KL_RHO_WIDE][0].nnz
    for dtype in (torch.float64, torch.float32):
        name = cs.dtype_name(dtype)
        Q = cs.random_posterior(dn, cs.DN_CHAINS, dtype, dev, 6)
        cases = [(f"B={cs.DN_CHAINS} n={dn.n}", Q)]
        cases += [(f"B=1 n={nx * ny}", cs.lattice_precision(nx, ny, dtype, dev)) for nx, ny in cs.DENSE_SHAPES]
        for label, Q in cases:
            data, t = Q.data.contiguous(), td._tables(Q.pattern)
            ms = cs.cuda_ms(lambda: kernels.dense_chol(data, t))
            print(f"{tree}: dense_chol {label} {name} {ms:.4f} ms on {card}", flush=True)
        inputs = cs.kl_bucket_inputs(kp, cs.KL_RHO_WIDE, dtype, dev)
        bucket, nnz_s = cs.synthetic_kl_bucket(np.random.default_rng(18), dtype, dev)
        for label, buckets, size in ((f"n={len(kp['X'])} rho={cs.KL_RHO_WIDE:g}, all buckets", inputs, nnz),
                                     ("synthetic cap=256", [bucket], nnz_s)):
            total = 0.0
            for cap, theta, count, pos in buckets:
                out = theta.new_zeros(size)
                total += cs.cuda_ms(lambda: kernels.kl_columns(theta, count, pos, cs.KL_JITTER, out))
            print(f"{tree}: kl_columns {label} {name} {total:.4f} ms on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
