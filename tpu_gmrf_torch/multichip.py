"""The port's twin of the reference's ``dryrun_multichip``
(``__graft_entry__.py:46-224``): every path of the package that lays work over
several devices, at the reference's tiny shapes, on a ``torch.distributed``
``DeviceMesh``.

`dryrun_multichip(mesh)` is called on every rank of `mesh` (SPMD), with a
one-dimensional mesh over all of them (a dimension named ``"chains"`` is
what `run_nuts` looks for); the SPIKE part builds a second mesh over the same
ranks whose dimension is named ``"time"``. Each part raises AssertionError if
its result is wrong; the results come back so that a caller can hold the
ranks against each other and against one process.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch.distributed.device_mesh import init_device_mesh

from .inference.marginal import laplace_marginal
from .models.ar import AR1Model
from .observations.exponential_family import ExponentialFamily
from .parallel import pbtridiag_logdet, pbtridiag_solve
from .samplers import nuts_kernel, run_advi, run_hmc, run_nuts, run_smc
from .samplers._mesh import all_sum, gather, shard
from .samplers.hmc import hmc_init
from .solvers.supernodal import supernodal_factorize
from .sparse.matrix import SparseMatrix
from .sparse.pattern import SparsePattern

__all__ = ["dryrun_multichip", "flagship_logdensity"]


def flagship_logdensity(n: int, device, dtype=torch.float32):
    """The reference's ``_flagship(n)`` as a log-density: z (B, 2) = (log τ,
    atanh ρ) ↦ the Laplace marginal of AR1(n) under Poisson counts y ~
    Poisson(2) from seed 0 (y in `dtype`; the reference's is float32)."""
    model, obs = AR1Model(n), ExponentialFamily("poisson")
    y = torch.tensor(np.random.default_rng(0).poisson(2.0, size=n), dtype=dtype, device=device)

    def logdensity(z):
        return laplace_marginal(model, obs, y, {"tau": torch.exp(z[..., 0]), "rho": torch.tanh(z[..., 1])})

    return logdensity


def _grid_precision(m: int, device) -> SparseMatrix:
    """Q = KᵀK, K = 2I + L (the graph Laplacian of the m×m grid), float32."""
    nn = m * m
    idx = np.arange(nn).reshape(m, m)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    W = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(nn, nn))
    K = (2.0 * sp.eye(nn) + sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W).tocsr()
    Qs = (K.T @ K).tocoo()
    pat = SparsePattern(Qs.row, Qs.col, (nn, nn))
    return SparseMatrix(torch.tensor(Qs.data[pat.sort_order], dtype=torch.float32, device=device), pat)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(mesh) -> dict:
    """The seven parts of the reference's dry run over `mesh`'s ranks, in its
    order: a sharded NUTS step, `run_nuts(mesh=)`, the SPIKE solve and logdet
    over Nt = 2·world, sharded SMC, sharded ADVI, `supernodal_factorize(mesh=)`
    on the 20×20 grid (logdet within 1e-5 of one process's) and
    `run_hmc(mesh=)`. Returns each part's outputs, whole on every rank."""
    world = mesh.size()
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" \
        else torch.device(mesh.device_type)
    f32 = dict(dtype=torch.float32, device=dev)
    logdensity = flagship_logdensity(16, dev)
    dim, n_chains = 2, world
    out = {}

    # 1. one NUTS step of chains sharded over the mesh, the mean acceptance summed over the ranks
    sh = shard(mesh, None, n_chains, "num_chains={total} must divide over {world} devices")
    kernel = nuts_kernel(logdensity, max_depth=4)
    state = hmc_init(logdensity, torch.zeros(sh.stop - sh.start, dim, **f32))
    gen = torch.Generator(device=dev).manual_seed(0)
    state, info = kernel(gen, state, 0.1, torch.ones(dim, **f32), sh.rows)
    pos, acc = gather(sh, state.position), all_sum(sh, info.accept_prob.sum()) / n_chains
    _check(pos.shape == (n_chains, dim) and bool(torch.isfinite(acc)), "the sharded NUTS step")
    out["step"] = dict(position=pos, accept=acc)

    # 2. run_nuts over the mesh
    res = run_nuts(logdensity, 7, torch.zeros(n_chains, dim, **f32), num_warmup=4, num_samples=4, max_depth=3,
                   mesh=mesh)
    _check(res.samples.shape == (n_chains, 4, dim) and bool(torch.isfinite(res.logdensity).all()),
           "run_nuts(mesh=)")
    out["nuts"] = res

    # 3. the SPIKE solve and logdet, one chunk of the time axis per rank
    tmesh = init_device_mesh(mesh.device_type, (world,), mesh_dim_names=("time",))
    Nt, ns = 2 * world, 3
    rng = np.random.default_rng(0)
    diag = rng.normal(size=(Nt, ns, ns)).astype(np.float32)
    diag = diag @ np.swapaxes(diag, -1, -2) + (ns + 1.0) * np.eye(ns, dtype=np.float32)
    sub = (0.05 * rng.normal(size=(Nt - 1, ns, ns))).astype(np.float32)
    b = rng.normal(size=(Nt, ns)).astype(np.float32)
    diag, sub, b = (torch.tensor(a, device=dev) for a in (diag, sub, b))
    with torch.no_grad():
        x, ld = pbtridiag_solve(diag, sub, b, tmesh), pbtridiag_logdet(diag, sub, tmesh)
    _check(x.shape == (Nt, ns) and bool(torch.isfinite(ld)), "the SPIKE solve over the time axis")
    out["spike"] = dict(x=x, logdet=ld)

    # 4. SMC with the particles over the mesh
    def log_prior(z):
        return -0.5 * (z * z).sum(-1)

    n_part = 4 * world
    init = torch.randn((n_part, dim), generator=torch.Generator(device=dev).manual_seed(2), **f32)
    smc = run_smc(log_prior, log_prior, 3, init, num_move_steps=1, hmc_num_steps=2, step_size=0.4, max_stages=4,
                  mesh=mesh)
    _check(smc.particles.shape == (n_part, dim) and bool(torch.isfinite(smc.log_evidence)), "run_smc(mesh=)")
    out["smc"] = smc

    # 5. ADVI with the ELBO's draws over the mesh
    advi = run_advi(log_prior, 4, torch.zeros(dim, **f32), num_steps=6, num_elbo_samples=2 * world, mesh=mesh)
    _check(bool(torch.isfinite(advi.elbo_trace).all()), "run_advi(mesh=)")
    out["advi"] = advi

    # 6. the supernodal factorization's class batches split over the mesh
    Q = _grid_precision(20, dev)
    with torch.no_grad():
        ld1, ldm = supernodal_factorize(Q).logdet(), supernodal_factorize(Q, mesh=mesh).logdet()
    _check(abs(float(ld1) - float(ldm)) <= 1e-5 * abs(float(ld1)), "supernodal_factorize(mesh=)'s logdet")
    out["supernodal"] = dict(single=ld1, mesh=ldm)

    # 7. fixed-length HMC over the chain mesh
    hmc = run_hmc(logdensity, 5, torch.zeros(n_chains, dim, **f32), num_warmup=4, num_samples=4,
                  num_integration_steps=3, mesh=mesh)
    _check(hmc.samples.shape == (n_chains, 4, dim) and bool(torch.isfinite(hmc.logdensity).all()),
           "run_hmc(mesh=)")
    out["hmc"] = hmc
    return out
