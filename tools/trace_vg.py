"""Time and trace one batched Laplace value+grad of tpu_gmrf_torch, from the
source tree given as the first argument; needs a CUDA device.

    python3 tools/trace_vg.py <root> [spatial] [flagship] [k9] [nuts]

``spatial`` is chip_smoke.py's phase 11 value+grad: the Matérn + Poisson
model on the 63x63 grid (n=5741), 4 chains at θ = (1, 0.3), 10 Newton
iterations, the supernodal prior and the default (auto -> banded) inner
solver, float64. ``flagship`` is phase 4's: AR1(500) + Poisson over 256
chains, in float32 and float64. ``k9`` is one K9 `dense_chol` launch at
phase 3c's shape (the g=16 posterior, B=8, n=450, f64): its host time per
call (200 calls enqueued, before the synchronize) and the host CUDA calls
of one call in a trace, with their host time. ``nuts`` runs phases 10 and
11's run_nuts (g=16, 8 chains, auto -> dense; n=5741, 4 chains, auto ->
banded; both uncut, f64) and prints their samples/s. Each value+grad case
is warmed up with 2 calls, then
timed over 3 calls (host clock around work that ends in
``torch.cuda.synchronize()``), then traced once with torch.profiler
(activities CPU and CUDA): the device's busy time and idle share, the
kernels' device time by name, and the port's kernel launches of that call.

To compare two trees on one card, unpack the other tree (``git archive``)
into a git-ignored directory and run both in turns in one command.
"""

import os
import sys
import time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the tree's own script: its model setups)
from tpu_gmrf_torch import kernels  # noqa: E402
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.samplers import value_and_grad  # noqa: E402

TOP = 14  # kernels listed by device time


def trace(label: str, ld, z) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        value_and_grad(ld, z)
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value_and_grad(ld, z)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    kernels.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value_and_grad(ld, z)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in kernels.launches().items() if v}
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3
    print(f"{os.path.relpath(root)} {label}: value+grad median {np.median(ts):.2f} ms (min {min(ts):.2f}, max "
          f"{max(ts):.2f}); traced call {wall:.2f} ms, device busy {busy:.2f} ms in {len(dev)} activities, idle "
          f"{100.0 * (1.0 - busy / wall):.1f}%; launches {counts}", flush=True)
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total / 1e3, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"    {name[:90]:90s} calls={c:6d} device_ms={t:9.3f} per_call_ms={t / c:.4f}", flush=True)


def trace_k9(dev) -> None:
    from torch.profiler import ProfilerActivity, profile

    from tpu_gmrf_torch.solvers import dense as td

    Q = cs.random_posterior(cs.spatial_model(cs.DN_GRID), cs.DN_CHAINS, torch.float64, dev, 6)
    data, t = Q.data.contiguous(), td._tables(Q.pattern)
    for _ in range(20):
        kernels.dense_chol(data, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernels.dense_chol(data, t)
    host = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kernels.dense_chol(data, t)
        call = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    calls: dict = {}
    for e in prof.events():
        if e.name.startswith("cuda") and e.name != "cudaDeviceSynchronize":
            n, us = calls.get(e.name, (0, 0.0))
            calls[e.name] = (n + 1, us + e.cpu_time_total)
    dev_ms = sum(e.device_time_total for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{os.path.relpath(root)} K9 dense_chol B={cs.DN_CHAINS} n={Q.shape[0]} f64: host {host:.4f} ms per "
          f"call (200 enqueued); one traced call {call:.4f} ms on the host, device {dev_ms / 1e3:.4f} ms; host CUDA "
          f"calls {', '.join(f'{k} x{n} {us:.1f} us' for k, (n, us) in sorted(calls.items()))}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_vg: no CUDA device", file=sys.stderr)
        return 1
    which = sys.argv[2:] or ["spatial", "flagship"]
    build.build()
    build.library()
    dev = torch.device("cuda")
    print(f"{os.path.relpath(root)} on {cs.card_line()}", flush=True)
    if "spatial" in which:
        model = cs.spatial_model(cs.SP_GRID)
        ld = cs.spatial_logdensity(model, cs.spatial_y(model, cs.SP_GRID), 10, inner=None)
        z = torch.tensor(np.tile([0.0, np.log(0.3)], (4, 1)), dtype=torch.float64, device=dev)
        trace("phase 11 value+grad (n=5741, B=4, auto inner solver, f64)", ld, z)
    if "flagship" in which:
        ld = cs.logdensity(cs.flagship_y())
        zz = np.random.default_rng(2).normal(scale=0.5, size=(cs.CHAINS, 2))
        for dtype in (torch.float32, torch.float64):
            trace(f"flagship value+grad (B=256, n=500, {'f32' if dtype == torch.float32 else 'f64'})", ld,
                  torch.tensor(zz, dtype=dtype, device=dev))
    if "k9" in which:
        trace_k9(dev)
    if "nuts" in which:
        for cfg, grid in ((cs.NUTS_G16, cs.NUTS_G16["grid"]), (cs.NUTS_5741, cs.SP_GRID)):
            model = cs.spatial_model(grid)
            ld = cs.spatial_logdensity(model, cs.spatial_y(model, grid), cfg["ga_iter"], inner=None)
            init = torch.tensor(np.tile([0.0, np.log(0.3)], (cfg["chains"], 1)), dtype=torch.float64, device=dev)
            res, secs, counts = cs.timed_nuts(ld, init, cfg["warmup"], cfg["samples"], cfg["depth"])
            print(f"{os.path.relpath(root)} run_nuts n={model.n}: {cs.nuts_line(res, secs)}; K8 launches "
                  f"{counts.get('sn_takahashi', 0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
