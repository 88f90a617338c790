"""The gloo workers of ``tests/test_torch_samplers_breadth.py``: the meshed
sampler cases, run once in one process and once on every rank of a
``torch.distributed`` group. Kept apart from the test module, which imports
JAX, so that each spawned rank imports only the port."""

import os

import torch

import tpu_gmrf_torch as tg
from tpu_gmrf_torch.multichip import dryrun_multichip, flagship_logdensity

F64 = torch.float64

MESH_CHAINS, MESH_PARTICLES, MESH_DRAWS = 8, 16, 8


def mesh_cases(mesh):
    """Every meshed entry on AR1(16)'s Laplace marginal in float64 (mesh None: one process)."""
    ld = flagship_logdensity(16, "cpu", F64)

    def log_prior(z):
        return -0.5 * (z * z).sum(-1)

    def log_lik(z):
        return ld(z) + 0.5 * (z * z).sum(-1)

    z0 = 0.3 * torch.randn((MESH_CHAINS, 2), generator=torch.Generator().manual_seed(4), dtype=F64)
    # broad enough that the tempering takes all three stages
    init = 2.0 * torch.randn((MESH_PARTICLES, 2), generator=torch.Generator().manual_seed(4), dtype=F64)
    return dict(
        nuts=tg.run_nuts(ld, 11, z0, num_warmup=4, num_samples=4, max_depth=3, mesh=mesh),
        hmc=tg.run_hmc(ld, 12, z0, num_warmup=4, num_samples=4, num_integration_steps=3, initial_step_size=0.2,
                       mesh=mesh),
        smc=tg.run_smc(log_prior, log_lik, 13, init, num_move_steps=1, hmc_num_steps=2, step_size=0.2, max_stages=3,
                       mesh=mesh),
        advi=tg.run_advi(ld, 14, torch.zeros(2, dtype=F64), num_steps=10, num_elbo_samples=MESH_DRAWS,
                         learning_rate=5e-2, mesh=mesh),
    )


def mesh_errors(mesh, world) -> dict:
    ld = flagship_logdensity(16, "cpu", F64)
    out = {}
    for name, call in (
        ("nuts", lambda: tg.run_nuts(ld, 0, torch.zeros(world + 1, 2, dtype=F64), num_warmup=1, num_samples=1,
                                     mesh=mesh)),
        ("smc", lambda: tg.run_smc(ld, ld, 0, torch.zeros(2 * world + 1, 2, dtype=F64), mesh=mesh)),
        ("advi", lambda: tg.run_advi(ld, 0, torch.zeros(2, dtype=F64), num_steps=1, num_elbo_samples=world + 1,
                                     mesh=mesh)),
    ):
        try:
            call()
        except ValueError as e:
            out[name] = str(e)
    return out


def dist_worker(rank, world, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    tg.set_default_device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("chains",))
        out = dict(cases=mesh_cases(mesh), errors=mesh_errors(mesh, world), dryrun=dryrun_multichip(mesh))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
