"""Backward error of the banded backend's kernels on a stiff joint: example 04's posterior (chip_smoke.py phase 26(a)).

Factors the posterior precision with K11 (`bt_factor`) and with its plain version on the card, solves Q x = Aᵀ Q_ε y
with K12 (`bt_trsv`) and with its plain version on each factor, and prints each pairing's relative residual
‖Qx − b‖∞ / (‖Q‖∞‖x‖∞ + ‖b‖∞), each factor's worst block backward error
max_k ‖L_k L_kᵀ + M_{k-1} M_{k-1}ᵀ − D_k‖ / ‖D_k‖ (and ‖M_k L_kᵀ − E_k‖ / ‖E_k‖), and the largest condition of a
64 × 64 diagonal tile of K11's factor: which of the two kernels carries a loss of backward error.

    python3 tools/banded_backward_error.py        (on a machine with a CUDA card; builds the kernels first)
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def block_backward_error(P, P0, s: int, K: int) -> tuple:
    """(worst relative block residual of the factor P against the scattered blocks P0, its block)."""
    worst, at = 0.0, -1
    for k in range(K):
        D = torch.tril(P0[0, k, :s]) + torch.tril(P0[0, k, :s], -1).mT
        L = torch.tril(P[0, k, :s])
        R = L @ L.mT - D
        if k > 0:
            R = R + P[0, k - 1, s:] @ P[0, k - 1, s:].mT
        e = float(R.abs().max() / D.abs().max())
        if k < K - 1:
            E = P0[0, k, s:]
            e = max(e, float((P[0, k, s:] @ L.mT - E).abs().max() / max(float(E.abs().max()), 1e-300)))
        if e > worst:
            worst, at = e, k
    return worst, at


def main() -> int:
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.kernels import banded as kb
    from tpu_gmrf_torch.kernels import build
    from tpu_gmrf_torch.solvers import banded as sb

    if not torch.cuda.is_available():
        print("banded_backward_error: no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.library()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    tg.set_default_device(dev)
    _, _, post, (A, y, prec) = cs.run_ex04(dev)
    tabs = sb._TABLES[post.factor.meta]
    Q = post.Q
    b = A.todense().T @ torch.tensor(prec * y, dtype=torch.float64, device=dev)
    data = Q.data[None].contiguous()
    factors = {"K11": kb.bt_factor(data, tabs)[0], "plain factor": kb.bt_factor_plain(data, tabs)[0]}
    for fname, P in factors.items():
        for sname, solve in (("K12", kb.bt_trsv), ("plain sweeps", kb.bt_trsv_plain)):
            x = solve(P, tabs, b[None].contiguous())[0]
            print(f"{fname} + {sname}: relative residual {cs.relative_residual(Q, x, b):.3e}", flush=True)
    s, K = tabs.s, tabs.K
    t = tabs.on(dev)
    v = data if t["tperm_l"] is None else 0.5 * (data + data[:, t["tperm_l"]])
    src = t["src_l"]
    P0 = torch.zeros(1, K * 2 * s * s, dtype=torch.float64, device=dev)
    P0[:, t["dst_l"]] = torch.where(src >= 0, v[:, src.clamp_min(0)], torch.ones((), dtype=v.dtype, device=dev))
    P0 = P0.view(1, K, 2 * s, s)
    for fname, P in factors.items():
        worst, at = block_backward_error(P, P0, s, K)
        print(f"{fname}: worst block backward error {worst:.3e} at block {at}", flush=True)
    Pk = factors["K11"]
    conds = [float(torch.linalg.cond(Pk[0, k, i:i + 64, i:i + 64])) for k in range(K) for i in range(0, s, 64)]
    print(f"largest condition of a 64 x 64 diagonal tile of K11's factor: {max(conds):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
