#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_gmrf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. the device: needs CUDA; prints the card's name and power limit;
2. the build: compiles the kernels K1-K4 from tpu_gmrf_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes (B=256 chains, n=500), in float64 and float32;
4. the slice: batched value and θ-gradient of the Laplace marginal of an
   AR1 + Poisson model through the kernels, in float32, checked against the
   plain path in float64 (the same code on CPU tensors) and against the
   kernel path in float64;
5. a few HMC steps over the 256 chains.

Every kernel's launch counter is zeroed just before the main path (phases 4
and 5) and read after it; a kernel of the path that was never launched
fails the run. The line before the last is one JSON object with the
kernels' launches, errors and times; the last line is the result object.
Needs no network and imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N = 500  # AR1 length, as the flagship workload
CHAINS = 256
GA_MAX_ITER = 25
HMC_STEPS, LEAPFROG = 5, 8
STEP_SIZE = 0.05
REPS = 20  # timed launches per kernel

# Normwise tolerances (max |kernel - plain| / max |plain|) of the kernel checks.
# float64: both sides are exact up to rounding order. float32: the kernels
# run the sequential recurrences while the plain versions run doubling scans
# (normalized Möbius products for the pivots); over n=500 steps the rounding
# of the two differs by up to ~n·eps.
KERNEL_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# The slice: the float64 kernel path against the float64 plain path differs
# only by rounding order (rel 1e-8 value, 1e-6 gradient, the Newton stop can
# move by one iteration). The float32 kernel path against the float64
# plain path: float32 rounding inside Newton and the logdets.
SLICE_TOL = {"f64_value": 1e-8, "f64_grad": 1e-6, "f32_value": 1e-4, "f32_grad": 5e-3}

SOURCES = {
    "tridiag_factor": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/prefix.py:53"),
    "tridiag_solve": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/prefix.py:33"),
    "tridiag_selinv": ("tpu_gmrf_torch/csrc/tridiag.cu", "tpu_gmrf/solvers/tridiag.py:70"),
    "csr_spmv": ("tpu_gmrf_torch/csrc/spmv.cu", "tpu_gmrf/sparse/matrix.py:58"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, normwise relative error) over matching tensors."""
    err = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.double().abs().max()) for r in ref)
    return err, err / max(scale, 1e-300)


# ---- phase 3: kernels against their plain versions ---------------------------


def kernel_inputs(dtype, dev):
    """Flagship-shaped inputs: AR1 posterior precisions Q_prior - H at random θ."""
    rng = np.random.default_rng(1)
    tau = np.exp(rng.normal(scale=0.5, size=(CHAINS, 1)))
    rho = np.tanh(rng.normal(scale=0.7, size=(CHAINS, 1)))
    hess = np.exp(rng.normal(scale=0.8, size=(CHAINS, N)))  # -∇² Poisson loglik = exp(x)
    a = np.concatenate([tau, np.repeat(tau * (1 + rho**2), N - 2, 1), tau], 1) + hess
    c = np.repeat(-rho * tau, N - 1, 1)
    x = rng.normal(size=(CHAINS, N))
    b = rng.normal(size=(CHAINS, N))
    return [torch.tensor(v, dtype=dtype, device=dev) for v in (a, c, x, b)]


def check_kernels(dtype, dev):
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.sparse.matrix import _csr, sp_tridiag

    a, c, x, b = kernel_inputs(dtype, dev)
    d, e, _ = kernels.tridiag_factor_plain(a, c)
    Q = sp_tridiag(a, c)
    rp, col = _csr(Q.pattern, dev)
    data = Q.data.contiguous()
    cases = {
        "tridiag_factor": (lambda: kernels.tridiag_factor(a, c), lambda: kernels.tridiag_factor_plain(a, c)),
        "tridiag_solve": (lambda: kernels.tridiag_solve(d, e, b), lambda: kernels.tridiag_solve_plain(d, e, b)),
        "tridiag_selinv": (lambda: kernels.tridiag_selinv(d, e), lambda: kernels.tridiag_selinv_plain(d, e)),
        "csr_spmv": (lambda: kernels.csr_spmv(rp, col, data, x, quad=True),
                     lambda: kernels.csr_spmv_plain(rp, col, data, x, quad=True)),
    }
    results = {}
    name_t = "f32" if dtype == torch.float32 else "f64"
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{name} {name_t}: non-finite kernel output")
        abs_err, rel = rel_err(got, ref)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        log(f"kernel {name} {name_t} B={CHAINS} n={N}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
            f"(tol {KERNEL_TOL[dtype]:.0e}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if not rel <= KERNEL_TOL[dtype]:
            raise AssertionError(f"{name} {name_t}: kernel disagrees with its plain version ({rel:.3e})")
        results[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}
    return results


# ---- phases 4-5: the slice ----------------------------------------------------


def flagship_y() -> np.ndarray:
    """AR1(τ=1, ρ=0.7) path from seed 0, y ~ Poisson(exp(clip(x, -3, 3)))."""
    rng = np.random.default_rng(0)
    tau, rho = 1.0, 0.7
    x = np.empty(N)
    x[0] = rng.normal() / np.sqrt(tau * (1 - rho**2))
    for t in range(1, N):
        x[t] = rho * x[t - 1] + rng.normal() / np.sqrt(tau)
    return rng.poisson(np.exp(np.clip(x, -3, 3))).astype(np.float32)


def logdensity(y):
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.samplers import LogitTransform, LogTransform, ParamSpec, make_logdensity

    model, obs = tg.AR1Model(N), tg.ExponentialFamily("poisson")
    spec = ParamSpec(
        tau=(LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
        rho=(LogitTransform(-1.0, 1.0), lambda r: 0.0),
    )
    opts = tg.GAOptions(max_iter=GA_MAX_ITER)
    return make_logdensity(lambda th: tg.laplace_marginal(model, obs, y, th, options=opts), spec)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_gmrf_torch import kernels
    from tpu_gmrf_torch.kernels import build
    from tpu_gmrf_torch.samplers import hmc_init, hmc_kernel, value_and_grad

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices={torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"phase 2 build: {os.path.basename(lib_path)} built and loaded in {time.perf_counter() - t0:.2f} s")

    log(f"phase 3 kernels vs plain on {card}")
    check_kernels(torch.float64, dev)
    k32 = check_kernels(torch.float32, dev)

    log(f"phase 4 slice: laplace_marginal value+grad, B={CHAINS}, n={N}, max_iter={GA_MAX_ITER}")
    y = flagship_y()
    z = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(CHAINS, 2)), dtype=torch.float32)
    ld = logdensity(y)

    kernels.reset_launches()
    # ---- main path: value+grad (float32, kernels) and HMC ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v32, g32 = value_and_grad(ld, z.to(dev))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        value_and_grad(ld, z.to(dev))
    torch.cuda.synchronize()
    vg_ms = (time.perf_counter() - t0) / reps * 1e3

    gen = torch.Generator(device=dev).manual_seed(1)
    step = hmc_kernel(ld, num_steps=LEAPFROG)
    state = hmc_init(ld, z.to(dev))
    accepts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HMC_STEPS):
        state, info = step(gen, state, STEP_SIZE, torch.ones(2, device=dev))
        accepts.append(info["accept_prob"].mean().item())
    torch.cuda.synchronize()
    hmc_ms = (time.perf_counter() - t0) / HMC_STEPS * 1e3
    counts = kernels.launches()
    # ---- end of the main path ----
    log(f"launches on the main path: {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # correctness of the slice
    v64p, g64p = value_and_grad(ld, z.double())  # plain path: the same code on CPU tensors
    v64k, g64k = value_and_grad(ld, z.double().to(dev))  # kernel path, float64
    for name, v, g in (("f64", v64k, g64k), ("f32", v32, g32)):
        v, g = v.double().cpu(), g.double().cpu()
        if not (torch.isfinite(v).all() and torch.isfinite(g).all()) or v.shape != (CHAINS,) or g.shape != (CHAINS, 2):
            raise AssertionError(f"slice {name}: non-finite or misshapen value/grad")
        v_rel = float(((v - v64p).abs() / v64p.abs()).max())
        g_rel = float(((g - g64p).abs().amax(-1) / g64p.abs().amax(-1).clamp_min(1.0)).max())
        log(f"slice {name} kernels vs f64 plain: value max rel {v_rel:.3e} (tol {SLICE_TOL[name + '_value']:.0e}), "
            f"grad max rel {g_rel:.3e} (tol {SLICE_TOL[name + '_grad']:.0e})")
        if not (v_rel <= SLICE_TOL[name + "_value"] and g_rel <= SLICE_TOL[name + "_grad"]):
            raise AssertionError(f"slice {name}: disagrees with the float64 plain path")
    log(f"slice f32 value+grad: first call {first_s:.3f} s, then {vg_ms:.2f} ms per batched "
        f"value+grad of {CHAINS} chains on {card}")

    pos = state.position
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("HMC positions are not finite")
    log(f"phase 5 HMC: {HMC_STEPS} steps x {LEAPFROG} leapfrog, step size {STEP_SIZE}: "
        f"{hmc_ms:.1f} ms per step, mean acceptance {np.mean(accepts):.3f} "
        f"(per step {', '.join(f'{a:.3f}' for a in accepts)}) on {card}")

    report = {
        "kernels": [
            {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
             "launches": counts[name], **k32[name]}
            for name in kernels.KERNELS
        ]
    }
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
