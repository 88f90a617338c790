"""Time and trace one batched Laplace value+grad of tpu_gmrf_torch, from the
source tree given as the first argument; needs a CUDA device.

    python3 tools/trace_vg.py <root> [spatial] [supernodal] [flagship] [k9] [k5] [k10] [tridiag] [bsr] [vgtimes]
        [hostcost] [kl18] [nuts] [flagnuts] [rbmc] [k7tiles] [glasso] [outer]

``spatial`` is chip_smoke.py's phase 11 value+grad: the Matérn + Poisson
model on the 63x63 grid (n=5741), 4 chains at θ = (1, 0.3), 10 Newton
iterations, the supernodal prior and the default (auto -> banded) inner
solver, float64. ``flagship`` is phase 4's: AR1(500) + Poisson over 256
chains, in float32 and float64. ``k9`` is one K9 `dense_chol` launch at
phase 3c's shape (the g=16 posterior, B=8, n=450, f64): its host time per
call (200 calls enqueued, before the synchronize) and the host CUDA calls
of one call in a trace, with their host time. ``k5`` and ``k10`` give K5's
and K10's host µs per call (200 calls enqueued before one synchronize) and
device µs per launch (a torch.profiler trace of 20 calls): K5 on phase 3b's
posterior (B=4, n=5741, f64) for the largest level's Schur reduction, the
logdet's sum and its launches per factorization and per solve, and on the
flagship's Q_p − H (`sp_add`, B=256, n=500, f32), and `selinv_dot`'s sum
on the posterior's pattern; K10 as the dense factor's solve (both
triangles, k=1) and `selinv_diag` at phase 3c's shape (the g=16 posterior,
B=8, n=450, f64), and at B=1 on the lattices of n=900, 1000 and 4096 in
f32 and f64 beside its plain version and `cholesky_solve` (CUDA events per
call). ``tridiag`` gives K1 `tridiag_factor`'s, K2 `tridiag_solve`'s
(mode 2, k=1) and K3 `tridiag_selinv`'s host µs per call (200 enqueued) and
device µs per launch (a torch.profiler trace of 20 calls), and their CUDA
events ms per call, at the flagship shape (B=256, n=500, chip_smoke.py's
kernel inputs) and at B=4, n=20000, in float32 and float64; at the flagship
shape, K1's and K2's host
time split into its pieces (the median of 15 rounds of 200 calls: the whole wrapper, the checks,
`_on_cuda`, the outputs as three allocations and as one allocation cut into
three views, the launch shape, the stream handle, the ctypes call with its
launch and without one, B = 0); and, on a tree with `scan_launch`, K1's and
K2's device µs per launch at the flagship shape on 1, 2, 4, 8 and 16 warps a
chain (16, 8, 4, 2 and 1 rows a thread). ``bsr`` gives K14 `bsr_spmm`'s host
µs per call, device µs per launch and CUDA events ms per call, forward and
transposed, beside the library product (`torch.sparse_bsr_tensor` of A, or
of Aᵀ, @ x) and the bound, on chip_smoke.py's phase 3d operators with 8
vectors: the n=14058 Matérn operator at bs = 8, 16 and 32 and the n=99856
grid precision at bs=8, in float32 and float64; on a tree with
`spmm_launch`, also the forward product at other splits (warps a group,
ring depth, shared bytes a group and a CTA). ``glasso`` gives K17
`block_inv`'s host µs per call (50 enqueued), device µs per launch and CUDA
events ms per call beside the library yardstick (`linalg.inv` per size
bucket, events) and the bound, on phase 3e's input: the n=1000 graphical
lasso's 1,673 cliques and separators, and the same sets plus one set of 200,
in float32 and float64. ``outer`` gives K15 `bsr_outer`'s host µs per call,
device µs per launch and CUDA events ms per call beside the bound and the
library yardstick, `torch.sparse.sampled_addmm` of Gᵀ X at the stored
blocks' scalar pattern (a CSR tensor built outside the timing, its values
held to K15's through a permutation; "none" where the card's PyTorch refuses
it), with 8 vectors on phase 3d's operators: the n=14058 Matérn operator at
bs = 8, 16 and 32, there at bs=8 also per chain (8 chains, each its own
output blocks; the yardstick a batched CSR tensor), and the n=99856 grid
precision at bs=8, in float32 and float64. ``vgtimes`` times 15 calls each
of phase 7's, phase 11's and the f32 flagship value+grad (host clock, each
call ending in a synchronize; after 2 warm-up calls) and prints every
time. ``hostcost`` (this tree's wrappers only) splits the host µs of one K5
call (the flagship's `sp_add` plan) into its pieces: the whole wrapper, the
ctypes call with its launch, the ctypes call without a launch (B = 0),
`_on_cuda`, the stream handle and `torch.cuda.current_stream` (2000 calls
each). ``kl18`` computes phase 18's KL n=900 d/dτ on the card with K10 and
with `dense_trsv_plain` (cuBLAS's trsm) in K10's place, against the plain
path on CPU tensors. ``flagnuts`` runs phase 9's run_nuts (the flagship, 256 chains, f32, depth 8,
10 + 10 draws) and prints its samples/s and K1/K2 launches. ``nuts`` runs phases 10 and
11's run_nuts (g=16, 8 chains, auto -> dense; n=5741, 4 chains, auto ->
banded; both uncut, f64) and prints their samples/s. ``supernodal`` is
phase 7's value+grad (the same model with the supernodal inner solver, 10
Newton iterations, float32 at phase 7's θ), then, on phase 3b's posterior
(B=4, n=5741, float64 and float32), one factorization and one solve at k=1
and at k=8: for K6 `sn_panel` and K7 `sn_trsv` each call's device time by
the class batches (W, M, P) it took (one, or a whole level's; the kernels'
launches matched in order to the wrapper calls that made them), and each
call's host time (the wrapper's enqueue). ``rbmc`` times chip_smoke.py's
phase 14 estimators, f64: rbmc_var at n=14058 (1000 draws, one backward
solve of 1000 right-hand sides) and block_rbmc_var at n=5741 (100 draws),
one warm-up and 3 timed calls each (host clock, ending in a synchronize;
block RBMC's host plan made before). ``k7tiles`` (this tree's K7 only)
times K7's two column tiles against each other around phase 14's shapes
(n=14058 B=1 k=1000, n=5741 B=1 k=100) and phase 3b's (n=5741 B=4 k=65,
the posterior), f64: the whole solve and backward solve with the tile
`trsv_launch` picks and with 8 forced, in turns (picked, 8, 8, picked),
by CUDA events; then each level's K7 launch alone, forward and backward,
with 8 and with 64 columns (8, 64, 64, 8).
Each value+grad case
is warmed up with 2 calls, then
timed over 3 calls (host clock around work that ends in
``torch.cuda.synchronize()``), then traced once with torch.profiler
(activities CPU and CUDA): the device's busy time and idle share, the
kernels' device time by name, and the port's kernel launches of that call.

To compare two trees on one card, unpack the other tree (``git archive``)
into a git-ignored directory and run both in turns in one command.
"""

import importlib
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


class _Recorder:
    """Wraps the supernodal solver's K6 and K7 entries to record, per call, the
    class batch (W, M, P), the wrapper's launches and its host time."""

    KEYS = {"panel": ("sn_panel", kernels.sn_panel), "trsv": ("sn_trsv", kernels.sn_trsv)}

    def __init__(self):
        from tpu_gmrf_torch.solvers import supernodal as sn

        self.ops, self.calls = sn._KERNEL_OPS, []
        self.saved = {k: self.ops[k] for k in self.KEYS}
        for key, (name, fn) in self.KEYS.items():
            self.ops[key] = self._wrap(name, fn)

    def _wrap(self, name, fn):
        def run(vals, c, *args, **kw):
            before, t0 = fn.launches, time.perf_counter()
            out = fn(vals, c, *args, **kw)
            batches = c["classes"] if "classes" in c else [c]  # a level's group; one class batch in older trees
            self.calls.append((name, tuple((cc["W"], cc["M"], cc["panel"].shape[0]) for cc in batches),
                               fn.launches - before, (time.perf_counter() - t0) * 1e3))
            return out

        return run

    def restore(self):
        self.ops.update(self.saved)

    def by_batch(self, prof, name: str):
        """{((W, M, P), ...): [calls, device ms, host ms]} of kernel `name` over the calls recorded in `prof`, by the
        class batches a call took (one, or a level's)."""
        dev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and name in e.name), key=lambda e: e.time_range.start)
        out, i = {}, 0
        for nm, key, launches, host in self.calls:
            if nm != name:
                continue
            ms = sum(e.device_time_total for e in dev[i:i + launches]) / 1e3
            i += launches
            row = out.setdefault(key, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += ms
            row[2] += host
        if i != len(dev):
            print(f"    (warning: {len(dev)} {name} kernels traced, {i} matched to calls)", flush=True)
        return out


def print_batches(label: str, rows: dict, top: int = 12) -> None:
    total = sum(r[1] for r in rows.values())
    calls = sum(r[0] for r in rows.values())
    host = sum(r[2] for r in rows.values())
    print(f"  {label}: {calls} calls, device {total:.3f} ms, host (enqueue) {host:.3f} ms "
          f"({host / max(calls, 1):.4f} per call); by the class batches (W, M, P) of a call, the costliest {top}:",
          flush=True)
    for key, (c, ms, h) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"    calls={c:4d} device_ms={ms:8.4f} per_call_ms={ms / c:.4f} host_per_call_ms={h / c:.4f} "
              f"{' '.join('(%d,%d,%d)' % w for w in key)}", flush=True)


def traced(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def trace_supernodal(dev) -> None:
    from tpu_gmrf_torch.solvers import supernodal as sn
    from tpu_gmrf_torch.sparse.matrix import spdiag

    model = cs.spatial_model(cs.SP_GRID)
    y = cs.spatial_y(model, cs.SP_GRID)
    z = torch.tensor(np.tile([0.0, np.log(0.3)], (4, 1)) + np.random.default_rng(5).normal(scale=0.3, size=(4, 2)),
                     dtype=torch.float32, device=dev)
    rec = _Recorder()
    try:
        trace("phase 7 value+grad (n=5741, B=4, supernodal inner solver, f32)", cs.spatial_logdensity(model, y), z)
        rec.calls.clear()
        prof, wall = traced(lambda: value_and_grad(cs.spatial_logdensity(model, y), z))
        rec.calls = rec.calls[len(rec.calls) // 2:]  # the traced call's, after the warm-up's
        for name in ("sn_panel", "sn_trsv"):
            print_batches(f"phase 7 value+grad {name}", rec.by_batch(prof, name))
        B, n = 4, model.n
        rng = np.random.default_rng(3)
        for dtype in (torch.float64, torch.float32):
            prior = model.precision(tau=torch.ones(B, dtype=dtype, device=dev),
                                    range=torch.full((B,), 0.25, dtype=dtype, device=dev))
            post = prior + spdiag(torch.tensor(np.exp(rng.normal(scale=0.5, size=(B, n))), dtype=dtype, device=dev))
            tn = "f64" if dtype == torch.float64 else "f32"
            rec.calls.clear()
            prof, wall = traced(lambda: sn.supernodal_factorize(post))
            rec.calls = rec.calls[len(rec.calls) // 2:]
            print(f"{os.path.relpath(root)} phase 3b posterior factorization B={B} n={n} {tn}: one call {wall:.3f} "
                  f"ms (host clock, traced)", flush=True)
            print_batches(f"factorization {tn} sn_panel", rec.by_batch(prof, "sn_panel"), 46)
            f = sn.supernodal_factorize(post)
            for k in (1, 8):
                b = torch.tensor(rng.normal(size=(B, n, k) if k > 1 else (B, n)), dtype=dtype, device=dev)
                rec.calls.clear()
                prof, wall = traced(lambda: f.solve(b))
                rec.calls = rec.calls[len(rec.calls) // 2:]
                busy = sum(e.device_time_total for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                rows = rec.by_batch(prof, "sn_trsv")
                print(f"{os.path.relpath(root)} solve {tn} k={k}: one call {wall:.3f} ms (host clock, traced), device "
                      f"busy {busy:.3f} ms, idle {100.0 * (1.0 - busy / wall):.1f}%; solves by events "
                      f"{cs.cuda_ms(lambda: f.solve(b), 10, 2):.3f} ms", flush=True)
                print_batches(f"solve {tn} k={k} sn_trsv", rows, 8)
    finally:
        rec.restore()


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


def host_device(label: str, fn, reps: int = 200) -> None:
    """fn's host µs per call (`reps` calls enqueued before one synchronize) and
    device µs per launch (a torch.profiler trace of 20 calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev)
    names = sorted({e.name[:40] for e in dev})
    print(f"{os.path.relpath(root)} {label}: host {host:.2f} us per call ({reps} enqueued); device "
          f"{busy / max(len(dev), 1):.2f} us per launch, {len(dev) / 20:g} launches per call ({', '.join(names)})",
          flush=True)


def time_k5(dev) -> None:
    from tpu_gmrf_torch.solvers import supernodal as sn
    from tpu_gmrf_torch.sparse.matrix import _ADD_CACHE, sp_add, sp_tridiag, spdiag

    model = cs.spatial_model(cs.SP_GRID)
    B, dtype = cs.SP_CHAINS, torch.float64
    Q = cs.random_posterior(model, B, dtype, dev, 3)
    f = sn.supernodal_factorize(Q)
    dp = sn._device_plan(f.meta, dev)
    lv = max(dp["levels"], key=lambda lv: sum(p.rows for p in lv.schur))
    u = torch.randn(B, lv.zu + 1, dtype=dtype, device=dev)
    vals = f.vals.clone()
    host_device(f"K5 the largest Schur level ({len(lv.schur)} plans, {sum(p.rows for p in lv.schur)} rows), "
                f"B={B} n={model.n} f64", lambda: [kernels.gather_segsum(p, u, out=vals, alpha=-1.0, accumulate=True)
                                                   for p in lv.schur])
    plans = dp["logdet"] if isinstance(dp["logdet"], tuple) else (dp["logdet"],)  # two plans in older trees
    logs = torch.randn(B, 2 * model.n, dtype=dtype, device=dev)

    def logdet():
        x = logs
        for p in plans:
            x = kernels.gather_segsum(p, x)
        return x

    host_device(f"K5 the logdet sum ({len(plans)} plans)", logdet)
    # selinv_dot's sum on Q's pattern: one plan here, two (chunks, then their sum) in older trees
    dot = sn._sum_plan(Q.nnz, dot=True) if hasattr(sn, "_sum_plan") else sn._sum_plans(Q.nnz, dot=True)
    dot = dot if isinstance(dot, tuple) else (dot,)
    z = torch.randn(B, Q.nnz, dtype=dtype, device=dev)

    def selinv_sum():
        x = kernels.gather_segsum(dot[0], z, y=Q.data)
        for p in dot[1:]:
            x = kernels.gather_segsum(p, x)
        return x

    host_device(f"K5 the selinv_dot sum ({len(dot)} plans, {Q.nnz} terms, B={B})", selinv_sum)
    b = torch.randn(B, model.n, dtype=dtype, device=dev)
    per = {}
    for label, fn in (("factorization", lambda: sn.supernodal_factorize(Q)), ("solve", lambda: f.solve(b))):
        before = kernels.gather_segsum.launches
        fn()
        per[label] = kernels.gather_segsum.launches - before
    print(f"{os.path.relpath(root)} K5 launches per factorization {per['factorization']}, per solve {per['solve']}",
          flush=True)
    a, c, x, _ = cs.kernel_inputs(torch.float32, dev)
    Qf, H = sp_tridiag(a, c), spdiag(-x.exp())
    sp_add(Qf, H)
    plan = _ADD_CACHE[(Qf.pattern, H.pattern)][1][0]
    both = torch.cat([Qf.data, H.data], -1).contiguous()
    host_device(f"K5 sp_add (Q_p - H), B={cs.CHAINS} n={cs.N} f32", lambda: kernels.gather_segsum(plan, both))


def time_k10(dev) -> None:
    from tpu_gmrf_torch.solvers import dense as td

    Q = cs.random_posterior(cs.spatial_model(cs.DN_GRID), cs.DN_CHAINS, torch.float64, dev, 6)
    f = td.dense_factorize(Q)
    b = torch.randn(cs.DN_CHAINS, Q.shape[0], dtype=torch.float64, device=dev)
    with torch.no_grad():
        host_device(f"K10 solve (both triangles) B={cs.DN_CHAINS} n={Q.shape[0]} k=1 f64", lambda: f._solve_both(b))
        host_device(f"K10 selinv_diag B={cs.DN_CHAINS} n={Q.shape[0]} f64", f.selinv_diag, 20)
        # B=1 on the lattices of phases 15 and 16 (n=900, 1000) and at DENSE_MAX_N: K10 in mode 2, its plain
        # version and the library call s∘cholesky_solve(s∘b, L), CUDA events per call
        for dtype in (torch.float32, torch.float64):
            for nx, ny in ((30, 30), (40, 25), (64, 64)):
                Ql = cs.lattice_precision(nx, ny, dtype, dev)
                got = kernels.dense_chol(Ql.data.contiguous(), td._tables(Ql.pattern))
                L, s, tiles = got[0], got[1], got[4:]  # K9's tiles: none in older trees
                b1 = torch.randn(1, nx * ny, 1, dtype=dtype, device=dev)
                sb = s[..., None] * b1
                ms = [cs.cuda_ms(fn) for fn in (lambda: kernels.dense_trsv(L, s, b1, 2, *tiles),
                                                lambda: kernels.dense_trsv_plain(L, s, b1, 2),
                                                lambda: s[..., None] * torch.cholesky_solve(sb, L))]
                print(f"{os.path.relpath(root)} K10 mode 2 B=1 n={nx * ny} k=1 {cs.dtype_name(dtype)}: kernel "
                      f"{ms[0]:.4f} ms, plain {ms[1]:.4f}, library (cholesky_solve) {ms[2]:.4f} (CUDA events per call)",
                      flush=True)


def time_vg(dev) -> None:
    model = cs.spatial_model(cs.SP_GRID)
    y = cs.spatial_y(model, cs.SP_GRID)
    z7 = torch.tensor(np.tile([0.0, np.log(0.3)], (cs.SP_CHAINS, 1))
                      + np.random.default_rng(5).normal(scale=0.3, size=(cs.SP_CHAINS, 2)), dtype=torch.float32, device=dev)
    z11 = torch.tensor(np.tile([0.0, np.log(0.3)], (4, 1)), dtype=torch.float64, device=dev)
    zf = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(cs.CHAINS, 2)), dtype=torch.float32, device=dev)
    for label, ld, z in (("phase 7 value+grad (f32, supernodal inner solver)", cs.spatial_logdensity(model, y), z7),
                         ("phase 11 value+grad (f64, auto inner solver)", cs.spatial_logdensity(model, y, 10, inner=None), z11),
                         ("flagship value+grad (f32)", cs.logdensity(cs.flagship_y()), zf)):
        for _ in range(2):
            value_and_grad(ld, z)
        ts = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value_and_grad(ld, z)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        q = np.percentile(ts, [25, 50, 75])
        print(f"{os.path.relpath(root)} {label}: median {q[1]:.2f} ms, quartiles {q[0]:.2f} {q[2]:.2f}; "
              f"{' '.join(f'{t:.2f}' for t in ts)}", flush=True)


def host_cost(dev) -> None:
    from tpu_gmrf_torch.kernels import tridiag as kt
    from tpu_gmrf_torch.sparse.matrix import _ADD_CACHE, sp_add, sp_tridiag, spdiag

    a, c, x, _ = cs.kernel_inputs(torch.float32, dev)
    Q, H = sp_tridiag(a, c), spdiag(-x.exp())
    sp_add(Q, H)
    plan = _ADD_CACHE[(Q.pattern, H.pattern)][1][0]
    both = torch.cat([Q.data, H.data], -1).contiguous()
    out = both.new_empty(both.shape[0], plan.rows)
    fn, addr, st = kt._fn("tg_gather_segsum", torch.float32), plan.pack(out.get_device(), -(-both.shape[0] // 8)), kt._stream(out)
    args = (addr, out.data_ptr(), out.size(1), both.data_ptr(), both.size(1), None, 0, None, 0, 1.0, 0)
    for label, f in (("gather_segsum, the whole wrapper", lambda: kernels.gather_segsum(plan, both, out=out)),
                     ("the ctypes call with its launch", lambda: fn(*args, both.shape[0], st)),
                     ("the ctypes call, no launch (B = 0)", lambda: fn(*args, 0, st)),
                     ("_on_cuda of two tensors", lambda: kt._on_cuda("gather_segsum", out, both)),
                     ("the raw stream handle", lambda: kt._stream(out)),
                     ("torch.cuda.current_stream(...).cuda_stream",
                      lambda: torch.cuda.current_stream(out.device).cuda_stream)):
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            f()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"{os.path.relpath(root)} host cost, {label}: {us:.2f} us", flush=True)


def host_us(fn, reps: int = 200, rounds: int = 15) -> tuple[float, float, float]:
    """fn's host µs per call: quartiles over `rounds` rounds of `reps` calls enqueued before a
    synchronize (few enough that the launch queue never makes the host wait for the device)."""
    for _ in range(20):
        fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return tuple(np.percentile(per, [25, 50, 75]))


def time_tridiag(dev) -> None:
    from tpu_gmrf_torch.kernels import tridiag as kt

    scan = hasattr(kt, "scan_launch")  # this PR's wrappers; the parent's pass `in_global` instead
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.float64):
        for B, n in ((cs.CHAINS, cs.N), (4, 20000)):
            if n == cs.N:
                a, c, _, b = cs.kernel_inputs(dtype, dev)
            else:  # chip_smoke.py's n=20000 rows
                a = torch.tensor(2.5 + rng.random((B, n)), dtype=dtype, device=dev)
                c = torch.tensor(-rng.random((B, n - 1)), dtype=dtype, device=dev)
                b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=dev)
            d, e, _ = kernels.tridiag_factor_plain(a, c)
            label = f"B={B} n={n} {cs.dtype_name(dtype)}"
            k1, k2 = (lambda: kernels.tridiag_factor(a, c)), (lambda: kernels.tridiag_solve(d, e, b))
            k3 = lambda: kernels.tridiag_selinv(d, e)  # noqa: E731
            host_device(f"K1 tridiag_factor {label}", k1)
            host_device(f"K2 tridiag_solve mode 2 k=1 {label}", k2)
            host_device(f"K3 tridiag_selinv {label}", k3)
            print(f"{os.path.relpath(root)} K1 / K2 / K3 {label}: CUDA events {cs.cuda_ms(k1, 50, 5):.5f} / "
                  f"{cs.cuda_ms(k2, 50, 5):.5f} / {cs.cuda_ms(k3, 50, 5):.5f} ms per call (K3's plain version "
                  f"{cs.cuda_ms(lambda: kernels.tridiag_selinv_plain(d, e), 20, 3):.5f}); host µs per call, "
                  f"quartiles of 15 rounds of 200 enqueued: K1 {' '.join('%.2f' % q for q in host_us(k1))}, K2 "
                  f"{' '.join('%.2f' % q for q in host_us(k2))}", flush=True)
            if n != cs.N:
                continue
            el = a.element_size()
            fn1, fn2, st = kt._fn("tg_tridiag_factor", dtype), kt._fn("tg_tridiag_solve", dtype), kt._stream(a)
            out1, out2 = a.new_empty(2 * B * n), torch.empty_like(b)
            p1 = (a.data_ptr(), c.data_ptr(), out1.data_ptr(), out1.data_ptr() + el * B * n,
                  out1.data_ptr() + el * B * (2 * n - 1))
            p2 = (d.data_ptr(), e.data_ptr(), b.data_ptr(), out2.data_ptr())
            if scan:
                shape = kt.scan_launch(n)
                call1 = lambda rows: fn1(*p1, rows, n, *shape, st)  # noqa: E731
                call2 = lambda rows: fn2(*p2, rows, n, 1, 2, *shape, st)  # noqa: E731
                launch_shape = ("scan_launch", lambda: kt.scan_launch(n))
            else:
                call1 = lambda rows: fn1(*p1, rows, n, 0, st)  # noqa: E731
                call2 = lambda rows: fn2(*p2, rows, n, 1, 2, 0, st)  # noqa: E731
                launch_shape = ("tridiag_path", lambda: kt.tridiag_path(n, 0, dtype))
            pieces = (
                ("K1 tridiag_factor, the whole wrapper", k1),
                ("K2 tridiag_solve, the whole wrapper", k2),
                ("_check_rows", lambda: kt._check_rows("tridiag_factor", a, c)),
                ("_on_cuda of two tensors", lambda: kt._on_cuda("tridiag_factor", a, c)),
                ("_on_cuda of three tensors", lambda: kt._on_cuda("tridiag_solve", d, e, b)),
                ("outputs: three allocations (empty_like x2, new_empty)",
                 lambda: (torch.empty_like(a), torch.empty_like(c), a.new_empty(B))),
                ("outputs: one allocation cut into three views",
                 lambda: (lambda o: (o.as_strided((B, n), (n, 1)), o.as_strided((B, n - 1), (n - 1, 1), B * n),
                                     o.as_strided((B,), (1,), B * (2 * n - 1))))(a.new_empty(2 * B * n))),
                ("K2's output (empty_like)", lambda: torch.empty_like(b)),
                (f"the launch shape ({launch_shape[0]})", launch_shape[1]),
                ("the raw stream handle", lambda: kt._stream(a)),
                ("five data_ptr()", lambda: (a.data_ptr(), c.data_ptr(), d.data_ptr(), e.data_ptr(), b.data_ptr())),
                ("K1's ctypes call with its launch", lambda: call1(B)),
                ("K1's ctypes call, no launch (B = 0)", lambda: call1(0)),
                ("K2's ctypes call with its launch", lambda: call2(B)),
                ("K2's ctypes call, no launch (B = 0)", lambda: call2(0)),
            )
            print(f"{os.path.relpath(root)} host cost {label} (median of 15 rounds of 200 calls): "
                  + "; ".join(f"{name} {host_us(f)[1]:.2f} us" for name, f in pieces), flush=True)
            if scan:  # the warps a chain and rows a thread that hold n rows, picked and forced
                saved = kt.scan_launch
                shapes = [(w, -(-n // (32 * w))) for w in (1, 2, 4, 8, 16)]
                try:
                    for shape in shapes + shapes[::-1]:
                        kt.scan_launch = lambda n_, shape=shape: shape
                        host_device(f"K1 at (warps a chain, rows a thread) {shape} {label}", k1)
                        host_device(f"K2 at (warps a chain, rows a thread) {shape} {label}", k2)
                finally:
                    kt.scan_launch = saved


# K14's splits swept on a tree with `spmm_launch`, by block size: (warps a group, ring depth, shared bytes a
# group, shared bytes a CTA)
KIB = 1024
BSR_SPLITS = {
    8: ((1, 2, 16 * KIB, 72 * KIB), (1, 2, 8 * KIB, 72 * KIB), (1, 3, 24 * KIB, 72 * KIB),
        (1, 2, 32 * KIB, 72 * KIB), (2, 2, 16 * KIB, 72 * KIB), (1, 2, 16 * KIB, 48 * KIB)),
    16: ((2, 2, 16 * KIB, 72 * KIB), (2, 2, 32 * KIB, 72 * KIB), (2, 3, 24 * KIB, 72 * KIB),
         (4, 2, 16 * KIB, 72 * KIB), (1, 2, 16 * KIB, 72 * KIB)),
    32: ((4, 2, 16 * KIB, 72 * KIB), (8, 2, 16 * KIB, 72 * KIB), (4, 2, 16 * KIB, 96 * KIB),
         (4, 3, 16 * KIB, 72 * KIB), (4, 2, 96 * KIB, 100 * KIB)),
}


def time_bsr(dev) -> None:
    import warnings

    kb = importlib.import_module("tpu_gmrf_torch.kernels.bsr_spmv")  # the module, not the function

    rng = np.random.default_rng(13)
    stats = cs.spatial_model(cs.STATS_GRID)
    k = cs.SPMV_VECS
    for dtype in (torch.float32, torch.float64):
        for label, Q, sizes in (("Matérn", cs.matern_precision(stats, dtype, dev), (8, 16, 32)),
                                ("grid", cs.grid_precision(dtype, dev), (8,))):
            n, el = Q.shape[0], Q.data.element_size()
            x = torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=dev)
            xt = x.T.contiguous()
            for bs in sizes:
                Bm = kernels.bsr_from_sparse(Q, bs)
                plan, blocks = Bm.plan, Bm.blocks
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    bl, blt = cs.bsr_library(Bm, dev), cs.bsr_library_t(Bm, dev)
                    xpad = torch.nn.functional.pad(xt, (0, 0, 0, plan.nb * bs - n))
                    nbytes = el * (plan.nblocks * bs * bs + 2 * n * k) + 4 * (plan.nblocks + plan.nb + 1)
                    tag = (f"{label} n={n} k={k} bs={bs} nblocks={plan.nblocks} {cs.dtype_name(dtype)} (bound "
                           f"{nbytes / cs.HBM_BYTES_PER_S * 1e6:.2f} us)")
                    for name, kern, lib in (
                        ("forward", lambda: kernels.bsr_spmm(blocks, plan, x), lambda: bl @ xpad),
                        ("transposed", lambda: kernels.bsr_spmm(blocks, plan, x, True), lambda: blt @ xpad),
                    ):
                        host_device(f"K14 {name} {tag}", kern)
                        host_device(f"library {name} {tag}", lib)
                        print(f"{os.path.relpath(root)} K14 / library {name} {tag}: CUDA events "
                              f"{cs.cuda_ms(kern, 50, 5):.5f} / {cs.cuda_ms(lib, 50, 5):.5f} ms per call", flush=True)
                if hasattr(kb, "spmm_launch"):
                    saved = kb.spmm_launch
                    splits = BSR_SPLITS[bs]
                    try:
                        for sp in splits + splits[::-1]:
                            kb.spmm_launch = lambda bs_, sp=sp: sp
                            host_device(f"K14 forward at (warps a group, ring depth, group bytes, CTA bytes) {sp} "
                                        f"{tag}", lambda: kernels.bsr_spmm(blocks, plan, x))
                    finally:
                        kb.spmm_launch = saved
                del bl, blt


def time_glasso(dev) -> None:
    # phase 3e's input: the n=1000 graphical lasso's cliques (+1) and separators (-1), then with one set of 200
    _, _, Xall = cs.glasso_problem(cs.GL["n"], cs.GL["m"], cs.GL["density"], cs.GL["held_out"])
    gp = cs.glasso_host(Xall[:cs.GL["m"]], cs.GL["lam"])
    n = len(gp["mu"])
    sets = list(gp["cliques"]) + list(gp["seps"])
    big = sets + [np.sort(np.random.default_rng(18).choice(n, 200, replace=False))]
    cases = ((f"n={n} glasso", gp["blocks"]),
             (f"n={n} glasso + one set of 200",
              kernels.BlockSets(big, [1.0] * len(gp["cliques"]) + [-1.0] * (len(gp["seps"]) + 1))))
    for dtype in (torch.float32, torch.float64):
        C = torch.tensor(gp["C"], dtype=dtype, device=dev)
        el = torch.finfo(dtype).bits // 8
        for label, blocks in cases:
            s = blocks.sizes.astype(float)
            nbytes = el * 2 * float((s**2).sum()) + 4 * float(s.sum()) + (24 + el) * len(blocks)
            bnd = cs.bound(float((2 * s**3).sum()), nbytes, dtype)
            lib, nbuckets = cs.block_inv_library(C, blocks)
            tag = (f"{label} ({len(blocks)} sets, sizes {int(s.min())}-{int(s.max())}) {cs.dtype_name(dtype)} (bound "
                   f"{bnd['bound_ms'] * 1e3:.2f} us, {bnd['bound_by']})")
            host_device(f"K17 {tag}", lambda: kernels.block_inv(C, blocks), 50)
            print(f"{os.path.relpath(root)} K17 / library (linalg.inv per size bucket, {nbuckets} buckets) {tag}: "
                  f"CUDA events {cs.cuda_ms(lambda: kernels.block_inv(C, blocks), 20, 3):.5f} / "
                  f"{cs.cuda_ms(lib, 3, 1):.5f} ms per call", flush=True)


def sampled_pattern(plan, dev, chains: int = 0):
    """The scalar pattern of a BSR plan's stored blocks as the CSR tensor `torch.sparse.sampled_addmm` samples at
    (one batch entry per chain with `chains`), and the permutation that takes K15's (…, nblocks, bs, bs) output,
    flattened per chain, to that tensor's values. chip_smoke.py's `bsr_outer_library` does the same for its check;
    this copy also serves trees whose chip_smoke.py has none, and the per-chain yardstick."""
    t, bs, N = plan.on(dev), plan.bs, plan.nb * plan.bs
    ij = torch.arange(bs, device=dev)
    rows = (t["block_rows_l"][:, None, None] * bs + ij[None, :, None]).expand(-1, bs, bs).reshape(-1)
    cols = (t["block_cols_l"][:, None, None] * bs + ij[None, None, :]).expand(-1, bs, bs).reshape(-1)
    perm = torch.argsort(rows * N + cols)
    crow = torch.cat([rows.new_zeros(1), torch.bincount(rows, minlength=N).cumsum(0)])
    col, vals = cols[perm], torch.zeros(perm.numel(), device=dev)
    if chains:
        crow, col, vals = (a.expand(chains, -1).contiguous() for a in (crow, col, vals))
    return crow, col, vals, perm, N


def time_outer(dev) -> None:
    import warnings

    rng = np.random.default_rng(13)
    stats = cs.spatial_model(cs.STATS_GRID)
    k = cs.SPMV_VECS
    for dtype in (torch.float32, torch.float64):
        el = torch.finfo(dtype).bits // 8
        for label, Q, sizes in (("Matérn", cs.matern_precision(stats, dtype, dev), (8, 16, 32)),
                                ("grid", cs.grid_precision(dtype, dev), (8,))):
            n = Q.shape[0]
            g = torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=dev)
            x = torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=dev)
            for bs in sizes:
                plan = kernels.bsr_from_sparse(Q, bs).plan
                nbl = plan.nblocks
                modes = ((False, 0), (True, k)) if (label, bs) == ("Matérn", 8) else ((False, 0),)
                for per_chain, chains in modes:
                    nout = nbl * bs * bs * (chains or 1)
                    nbytes = el * (nout + 2 * n * k) + 8 * nbl
                    tag = (f"{label} n={n} k={k} bs={bs} nblocks={nbl}{' per chain' if per_chain else ''} "
                           f"{cs.dtype_name(dtype)} (bound {nbytes / cs.HBM_BYTES_PER_S * 1e6:.2f} us)")
                    kern = lambda: kernels.bsr_outer(plan, g, x, per_chain)  # noqa: E731
                    host_device(f"K15 {tag}", kern)
                    ms = cs.cuda_ms(kern, 50, 5)
                    # the yardstick: torch.sparse.sampled_addmm of Gᵀ X at the blocks' scalar pattern (its values in
                    # CSR order; K15's taken to that order by a permutation, both built outside the timing)
                    crow, col, vals, perm, N = sampled_pattern(plan, dev, chains)
                    gp = torch.nn.functional.pad(g, (0, N - n))
                    xp = torch.nn.functional.pad(x, (0, N - n))
                    m1, m2 = (gp[:, :, None], xp[:, None, :]) if per_chain else (gp.T.contiguous(), xp)
                    try:
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore", UserWarning)
                            S = torch.sparse_csr_tensor(crow, col, vals.to(dtype), size=((chains,) if chains else ())
                                                        + (N, N))
                            lib = lambda: torch.sparse.sampled_addmm(S, m1, m2, beta=0.0)  # noqa: E731
                            got = lib().values().reshape(chains or 1, -1)
                        ref = kern().reshape(chains or 1, -1)[:, perm]
                        err = float((got - ref).abs().max() / ref.abs().max())
                        host_device(f"library sampled_addmm {tag}", lib)
                        lms = f"{cs.cuda_ms(lib, 50, 5):.5f} ms per call ({err:.1e} from K15)"
                    except (RuntimeError, NotImplementedError) as e:
                        lms = f"none: sampled_addmm refused ({str(e).splitlines()[0][:120]})"
                    print(f"{os.path.relpath(root)} K15 / library {tag}: CUDA events {ms:.5f} ms per call / {lms}",
                          flush=True)


def kl18(dev) -> None:
    import dataclasses

    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.kl_cholesky import gram
    from tpu_gmrf_torch.solvers import dense as td
    from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern

    X = cs.grid_points(cs.KL_GRID_SMALL)
    n = len(X)
    rng = np.random.default_rng(123)
    rng.integers(0, n, size=12)  # as phase 18: example 09's probe columns, then its observations
    obs = rng.integers(0, n, size=5)
    y = np.sin(4 * X[obs, 0]) * np.cos(3 * X[obs, 1])
    g = tg.approximate_gmrf_kl(torch.tensor(X, device=dev), gram(cs.matern32), rho=cs.KL_RHO, jitter=cs.KL_JITTER)
    g = dataclasses.replace(g, mean=g.mean.detach(), Q=SparseMatrix(g.Q.data.detach(), g.Q.pattern))

    def dtau(where):
        t = torch.tensor(1.0, dtype=torch.float64, device=where, requires_grad=True)
        A = SparseMatrix(torch.ones(len(obs), dtype=torch.float64, device=where),
                         SparsePattern(np.arange(len(obs)), obs, (len(obs), n)))
        prior = tg.GMRF.from_precision(g.mean.to(where), SparseMatrix(g.Q.data.to(where) * t, g.Q.pattern))
        tg.linear_condition(prior, y, Q_eps=1e4, A=A).mean.sum().backward()
        return float(t.grad)

    plain, kernel = dtau("cpu"), td.dense_trsv
    for label, trsv in (("K10", kernel), ("cuBLAS trsm (dense_trsv_plain)",
                                          lambda L, s, b, mode=2, Dinv=None: kernels.dense_trsv_plain(L, s, b, mode))):
        td.dense_trsv = trsv
        try:
            got = dtau(dev)
        finally:
            td.dense_trsv = kernel
        print(f"{os.path.relpath(root)} phase 18 KL n={n} d/dτ with {label}: {got!r}, plain path {plain!r}, "
              f"rel {abs(got - plain) / abs(plain):.3e}", flush=True)


def time_rbmc(dev) -> None:
    import tpu_gmrf_torch as tg
    from tpu_gmrf_torch.solvers.rbmc import _block_rbmc_plan, block_rbmc_var, rbmc_var

    gen = torch.Generator(device=dev).manual_seed(7)
    for grid, fn, S in ((cs.STATS_GRID, rbmc_var, cs.RBMC_SAMPLES), (cs.SP_GRID, block_rbmc_var,
                                                                     cs.BLOCK_RBMC_SAMPLES)):
        Q = cs.matern_precision(cs.spatial_model(grid), torch.float64, dev)
        if fn is block_rbmc_var:
            _block_rbmc_plan(Q.pattern, 1)
        with torch.no_grad():
            g = tg.GMRF.from_precision(torch.zeros(Q.shape[0], dtype=torch.float64, device=dev), Q,
                                       tg.SolverSpec(kind="supernodal"))
        fn(g, gen, n_samples=S)
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(g, gen, n_samples=S)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"{os.path.relpath(root)} {fn.__name__} n={Q.shape[0]} S={S} f64: median {np.median(ts):.2f} ms "
              f"(min {min(ts):.2f}, max {max(ts):.2f})", flush=True)


def time_k7_tiles(dev) -> None:
    from tpu_gmrf_torch.kernels import supernodal as ks
    from tpu_gmrf_torch.solvers import supernodal as sn
    from tpu_gmrf_torch.sparse.matrix import spdiag

    picked = ks.trsv_launch
    rng = np.random.default_rng(9)

    def forced(nt):
        return lambda W, k, units, sms: (nt, -(-k // nt))

    for grid, B, ks_ in ((cs.STATS_GRID, 1, (65, 100, 256, cs.RBMC_SAMPLES)),
                         (cs.SP_GRID, 1, (16, 65, cs.BLOCK_RBMC_SAMPLES, 256, 1000)), (cs.SP_GRID, 4, (16, 65))):
        model = cs.spatial_model(grid)
        Q = model.precision(tau=torch.ones(B, dtype=torch.float64, device=dev),
                            range=torch.full((B,), 0.25, dtype=torch.float64, device=dev))
        if B > 1:  # phase 3b's posterior
            Q = Q + spdiag(torch.tensor(np.exp(rng.normal(scale=0.5, size=(B, model.n))), device=dev))
        f = sn.supernodal_factorize(Q)
        levels = sn._device_plan(f.meta, dev)["levels"]
        for k in ks_:
            b = torch.tensor(rng.normal(size=(B, model.n, k)), dtype=torch.float64, device=dev)
            tiles = [picked(max(c["W"] for c in lv.classes), k, B * sum(c["panel"].shape[0] for c in lv.classes),
                            ks._sm_count(dev))[0] for lv in levels]
            row = {}
            for form in ("picked", "8", "8", "picked"):
                ks.trsv_launch = picked if form == "picked" else forced(8)
                try:
                    with torch.no_grad():
                        for name, fn in (("solve", f.solve), ("backward_solve", f.backward_solve)):
                            row.setdefault((name, form), []).append(cs.cuda_ms(lambda: fn(b), 5, 2))
                finally:
                    ks.trsv_launch = picked
            print(f"{os.path.relpath(root)} K7 column tiles, n={model.n} B={B} k={k} f64 (picked by level: "
                  f"{' '.join(map(str, tiles))}):", flush=True)
            for name in ("solve", "backward_solve"):
                print(f"    {name}: picked {' '.join('%.3f' % t for t in row[(name, 'picked')])} ms, all 8 "
                      f"{' '.join('%.3f' % t for t in row[(name, '8')])} ms", flush=True)
            # each level's K7 launch alone, forward and backward, with 8 and with 64 columns where 64 fit
            xp = torch.zeros(B * k, model.n + 1, dtype=torch.float64, device=dev)
            xp[:, :-1] = torch.tensor(rng.normal(size=(B * k, model.n)), device=dev)
            for li, lv in enumerate(levels):
                Wmax = max(c["W"] for c in lv.classes)
                if Wmax > 2 * ks.K8_TILE:
                    continue
                u = xp.new_zeros(B * k, lv.zf + 1)
                ms = {}
                for nt in (8, 64, 64, 8):
                    ks.trsv_launch = forced(nt)
                    try:
                        for mode in (ks.FORWARD, ks.BACKWARD):
                            x0 = xp.clone()
                            ms.setdefault((mode, nt), []).append(cs.cuda_ms(
                                lambda: ks.sn_trsv(f.vals, lv.group, x0, u, mode, k), 10, 2))
                    finally:
                        ks.trsv_launch = picked
                units = B * sum(c["panel"].shape[0] for c in lv.classes)
                print(f"    level {li:2d} Wmax={Wmax:3d} units={units:4d} k={k:4d}: forward 8 "
                      f"{np.mean(ms[(0, 8)]):.4f} 64 {np.mean(ms[(0, 64)]):.4f}, backward 8 "
                      f"{np.mean(ms[(1, 8)]):.4f} 64 {np.mean(ms[(1, 64)]):.4f} ms", flush=True)


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
    if "supernodal" in which:
        trace_supernodal(dev)
    if "k9" in which:
        trace_k9(dev)
    if "k5" in which:
        time_k5(dev)
    if "k10" in which:
        time_k10(dev)
    if "tridiag" in which:
        time_tridiag(dev)
    if "bsr" in which:
        time_bsr(dev)
    if "glasso" in which:
        time_glasso(dev)
    if "outer" in which:
        time_outer(dev)
    if "vgtimes" in which:
        time_vg(dev)
    if "hostcost" in which:
        host_cost(dev)
    if "kl18" in which:
        kl18(dev)
    if "rbmc" in which:
        time_rbmc(dev)
    if "k7tiles" in which:
        time_k7_tiles(dev)
    if "flagnuts" in which:
        cfg = cs.NUTS_FLAGSHIP
        res, secs, counts = cs.timed_nuts(cs.logdensity(cs.flagship_y()),
                                          torch.zeros(cs.CHAINS, 2, dtype=torch.float32, device=dev),
                                          cfg["warmup"], cfg["samples"], cfg["depth"], 1)
        print(f"{os.path.relpath(root)} phase 9 flagship run_nuts: {cs.nuts_line(res, secs)}; K1 / K2 launches "
              f"{counts['tridiag_factor']} / {counts['tridiag_solve']}", flush=True)
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
