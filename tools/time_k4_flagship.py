"""Time the CSR kernel K4 of tpu_gmrf_torch at the flagship shape (256 chains,
n=500, the shared-memory path), with and without the fused quadratic form,
beside CSR ``torch.sparse.mm`` on the same values (the chains as one
block-diagonal matrix, as chip_smoke.py's phase 3 builds it), from the
source tree given as the first argument; needs a CUDA device.

To compare two trees on one card, unpack the other tree (``git archive``)
into a git-ignored directory and run both in turns within one session:

    for t in parent . . parent; do python3 tools/time_k4_flagship.py $t; done

Each run builds that tree's kernels and prints, per case, the median, min
and max of 7 timings of 200 back-to-back calls (CUDA events: the device
timeline, host gaps included), the host time per call (the 200 calls
enqueued, before the synchronize) and the device time per call (the
kernels' time in a torch.profiler trace of 200 calls, over 200).
"""

import os
import sys
import time
import warnings

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_gmrf_torch import kernels  # noqa: E402
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.sparse.matrix import _csr, sp_tridiag  # noqa: E402

B, N = 256, 500
CALLS, TIMINGS = 200, 7


def device_ms(fn) -> float:
    """Device time per call: the CUDA activities of CALLS calls in a trace, over CALLS."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time_total for e in dev) / 1e3 / CALLS


def timings(fn) -> str:
    for _ in range(20):
        fn()
    ev, host = [], []
    for _ in range(TIMINGS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / CALLS)
        e.record()
        torch.cuda.synchronize()
        ev.append(s.elapsed_time(e) / CALLS)
    return (f"median {np.median(ev):.4f} ms (min {min(ev):.4f}, max {max(ev):.4f}), host {np.median(host):.4f}, "
            f"device {device_ms(fn):.4f}")


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
        nnz = col.numel()
        crow = torch.cat([rp[:-1].long() + b * nnz for b in range(B)] + [torch.tensor([B * nnz], device=dev)])
        with warnings.catch_warnings():  # "beta" and invariant-check notices of sparse CSR
            warnings.simplefilter("ignore", UserWarning)
            bd = torch.sparse_csr_tensor(crow, torch.cat([col.long() + b * N for b in range(B)]), data.reshape(-1),
                                         size=(B * N, B * N))
        xcol = x.reshape(-1, 1).contiguous()
        y_lib = torch.sparse.mm(bd, xcol).reshape(B, N)
        y_k, q_k = kernels.csr_spmv(rp, col, data, x, quad=True)
        torch.cuda.synchronize()
        err = float((y_k - y_lib).abs().max() / y_lib.abs().max())
        name = "f32" if dtype == torch.float32 else "f64"
        cases = {"quad=True": lambda: kernels.csr_spmv(rp, col, data, x, quad=True),
                 "quad=False": lambda: kernels.csr_spmv(rp, col, data, x),
                 "sparse.mm": lambda: torch.sparse.mm(bd, xcol)}
        for label, fn in cases.items():
            out.append(f"{name} {label}: {timings(fn)}")
        out.append(f"{name} |K4 - sparse.mm| / max {err:.1e}, quad finite {bool(torch.isfinite(q_k).all())}")
    print(os.path.basename(root.rstrip("/")) or root, "|", " | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
