"""Probe of the float32 pivot boosts at n=5741 (chip_smoke.py phase 25(b)'s spatial prior).

Builds the Matérn prior's float32 Q at phase 25(b)'s four θ on the card and on CPU tensors, then factors each Q
with the kernels on the card, the plain versions on the card and the plain versions on CPU tensors, and prints per
chain the boosted pivots and the f32 logdet's distance from the f64 logdet. Which Q and which arithmetic carries a
breakdown tells whether the assembly or the factorization differs between the card and the CPU.

    python3 tools/fault35_probe.py        (on a machine with a CUDA card; builds the kernels first)
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def theta() -> np.ndarray:
    """Phase 25(b)'s four chains: (log τ, log range) from seed 7."""
    return np.tile([0.0, np.log(0.3)], (cs.SP_CHAINS, 1)) + np.random.default_rng(7).normal(scale=0.3,
                                                                                          size=(cs.SP_CHAINS, 2))


def precision(model, p: np.ndarray, dtype, dev):
    pp = torch.tensor(p, dtype=dtype, device=dev)
    return model.precision(tau=torch.exp(pp[:, 0]), range=torch.exp(pp[:, 1]))


def main() -> int:
    from tpu_gmrf_torch.kernels import build
    from tpu_gmrf_torch.solvers import supernodal as sn
    from tpu_gmrf_torch.sparse import SparseMatrix

    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        build.build()
        build.library()
        print(cs.card_line(), flush=True)
    model = cs.spatial_model(cs.SP_GRID)
    p = theta()
    print("theta per chain (log tau, log range):", np.array2string(p, precision=4), flush=True)
    Q64 = precision(model, p, torch.float64, torch.device("cpu"))
    ref = sn._factorize(Q64, 2048, "auto", sn._PLAIN_OPS)
    piv = ref.vals[:, torch.as_tensor(ref.plan["diag_pos"])].square().amin(-1)
    print("f64 logdet", ref.logdet().tolist(), "smallest scaled pivot", piv.tolist(), flush=True)
    Qs = {"card-built": precision(model, p, torch.float32, dev),
          "CPU-built": precision(model, p, torch.float32, torch.device("cpu")),
          "f64-built, rounded": SparseMatrix(Q64.data.float(), Q64.pattern)}
    d = (Qs["card-built"].data.cpu().double() - Qs["CPU-built"].data.double()).abs()
    scale = Qs["CPU-built"].data.double().abs().amax(-1, keepdim=True)
    print(f"f32 Q card-built vs CPU-built: entries differing {int((d > 0).sum())} of {d.numel()}, "
          f"max abs diff / max |Q| per chain {(d / scale).amax(-1).tolist()}", flush=True)
    routes = [("kernels on the card", sn._KERNEL_OPS, dev), ("plain on the card", sn._PLAIN_OPS, dev),
              ("plain on CPU tensors", sn._PLAIN_OPS, torch.device("cpu"))]
    for qname, Q in Qs.items():
        for rname, ops, where in routes:
            if where.type == "cuda" and not cuda:
                continue
            Qw = SparseMatrix(Q.data.to(where), Q.pattern)
            t0 = time.perf_counter()
            with torch.no_grad():
                f = sn._factorize(Qw, 2048, "auto", ops)
                ld = f.logdet().double().cpu()
            if where.type == "cuda":
                torch.cuda.synchronize()
            rel = ((ld - ref.logdet()).abs() / ref.logdet().abs()).tolist()
            print(f"{qname} f32 Q, {rname}: boosts {f.boost.cpu().tolist()}, f32 logdet rel distance from f64 "
                  f"{['%.3e' % r for r in rel]} ({time.perf_counter() - t0:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
