"""Time the CSR kernel K4 of tpu_gmrf_torch at the flagship shape (256 chains,
n=500, the shared-memory path), with and without the fused quadratic form,
from the source tree given as the first argument; needs a CUDA device.

To compare two trees on one card, unpack the other tree (``git archive``)
into a git-ignored directory and run both in turns within one session:

    for t in parent . . parent; do python3 tools/time_k4_flagship.py $t; done

Each run builds that tree's kernels and prints the median, min and max of 7
timings of 200 launches (CUDA events) per case.
"""

import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_gmrf_torch import kernels  # noqa: E402
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.sparse.matrix import _csr, sp_tridiag  # noqa: E402

B, N = 256, 500


def main() -> int:
    if not torch.cuda.is_available():
        print("time_k4_flagship: no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.library()
    dev = torch.device("cuda")
    out = []
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(1)
        a = torch.tensor(2.5 + rng.random((B, N)), dtype=dtype, device=dev)
        c = torch.tensor(-rng.random((B, N - 1)), dtype=dtype, device=dev)
        x = torch.tensor(rng.normal(size=(B, N)), dtype=dtype, device=dev)
        Q = sp_tridiag(a, c)
        rp, col = _csr(Q.pattern, dev)
        data = Q.data.contiguous()
        for quad in (True, False):
            def fn():
                return kernels.csr_spmv(rp, col, data, x, quad=quad)
            for _ in range(20):
                fn()
            ts = []
            for _ in range(7):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                s.record()
                for _ in range(200):
                    fn()
                e.record()
                torch.cuda.synchronize()
                ts.append(s.elapsed_time(e) / 200)
            out.append(f"{'f32' if dtype == torch.float32 else 'f64'} quad={quad}: median {np.median(ts):.4f} ms "
                       f"(min {min(ts):.4f}, max {max(ts):.4f})")
    print(os.path.basename(root.rstrip("/")), " | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
