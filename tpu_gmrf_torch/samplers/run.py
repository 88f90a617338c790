"""Sampling driver over B chains: warmup (dual averaging + Welford mass) and
sampling.

Counterpart of ``tpu_gmrf.samplers.run``. The reference vmaps
``_single_chain`` (``run.py:54-126``) over chains; here the chains are the
leading axis of every state, and each chain keeps its own step size and
diagonal mass matrix, as the vmapped chains do. The warmup schedule is the
same for every chain and is read on the host.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) lays the chains over the
ranks of its dimension named ``"chains"``, else of its dimension 0, as the
reference lays them over ``NamedSharding(mesh, P("chains"))``. Every rank
calls the entry point with the same arguments; each runs its contiguous
block of chains, drawing every transition's numbers for the whole batch from
the same seed and keeping its rows, so a chain's draws do not depend on the
mesh; one ``all_gather`` per field then gives every rank the whole
`NUTSResult`. Not ported: the reference's ``dispatch_chunk`` and
``hoist_jit`` (workarounds for the TPU's dispatch limits; PyTorch runs
eagerly, one transition at a time).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._device import as_tensor
from ._mesh import gather, shard
from .adaptation import da_init, da_update, warmup_schedule, welford_init, welford_update, welford_variance
from .hmc import hmc_init, hmc_kernel
from .nuts import nuts_kernel

__all__ = ["run_nuts", "run_hmc", "NUTSResult"]


class _HMCInfo(NamedTuple):
    accept_prob: Any
    diverging: Any
    depth: Any


class NUTSResult(NamedTuple):
    samples: Any  # (chains, num_samples, dim)
    logdensity: Any  # (chains, num_samples)
    step_size: Any  # (chains,)
    inv_mass: Any  # (chains, dim)
    accept_prob: Any  # (chains, num_samples)
    diverging: Any  # (chains, num_samples)
    depth: Any  # (chains, num_samples)


def _generator(key, device) -> torch.Generator:
    """`key` as a generator on `device`: a torch.Generator as given, or an int seed."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _run(logdensity_fn, kernel, key, init_positions, num_warmup, num_samples, initial_step_size,
         target_accept, mesh, progress_every):
    if num_samples < 1:
        raise ValueError("num_samples must be at least 1")
    z = as_tensor(init_positions)
    z = z[None] if z.ndim == 1 else z
    rows = None
    if mesh is not None:
        axis = "chains" if "chains" in (mesh.mesh_dim_names or ()) else None
        sh = shard(mesh, axis, z.shape[0], "num_chains={total} must divide over {world} devices")
        z, rows = z[sh.start: sh.stop], sh.rows
    num_chains, dim = z.shape
    dtype, dev = z.dtype, z.device
    gen = _generator(key, dev)
    state = hmc_init(logdensity_fn, z)
    is_slow, window_end = warmup_schedule(num_warmup)
    da = da_init(torch.full((num_chains,), initial_step_size, dtype=dtype, device=dev))
    welford = welford_init(dim, dtype, (num_chains,), dev)
    inv_mass = torch.ones(num_chains, dim, dtype=dtype, device=dev)
    for t in range(num_warmup):
        state, info = kernel(gen, state, torch.exp(da.log_step), inv_mass, rows)
        da = da_update(da, info.accept_prob, target=target_accept)
        if is_slow[t]:
            welford = welford_update(welford, state.position)
        if window_end[t]:
            # window end: refresh mass, reset welford + dual averaging
            inv_mass = welford_variance(welford)
            da = da_init(torch.exp(da.log_step))
            welford = welford_init(dim, dtype, (num_chains,), dev)
        if progress_every and (t + 1) % progress_every == 0:
            print(f"warmup {t + 1}/{num_warmup}", flush=True)
    step_size = torch.exp(da.log_step_avg)
    out = []
    for i in range(num_samples):
        state, info = kernel(gen, state, step_size, inv_mass, rows)
        out.append((state.position, state.logdensity, info.accept_prob, info.diverging, info.depth))
        if progress_every and i % progress_every == 0:
            print(f"sampling draw {i}/{num_samples}  logdensity={state.logdensity.tolist()}", flush=True)
    positions, lds, accept, div, depth = (torch.stack(x, 1) for x in zip(*out))
    result = NUTSResult(positions, lds, step_size, inv_mass, accept, div, depth)
    if mesh is not None:
        result = NUTSResult(*(gather(sh, t) for t in result))
    return result


def run_nuts(
    logdensity_fn: Callable,
    key,
    init_positions,
    num_warmup: int = 500,
    num_samples: int = 1000,
    max_depth: int = 10,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    mesh=None,
    progress_every: int | None = None,
) -> NUTSResult:
    """Multi-chain NUTS. `logdensity_fn` maps (chains, dim) to (chains,);
    `key` is a torch.Generator or an int seed; `init_positions`: (chains,
    dim) or (dim,) — a tensor keeps its device, anything else goes to the
    package's default device. `mesh` (a ``DeviceMesh``) lays the chains over
    its ranks (see the module's docstring; with a generator for `key`, give
    every rank one in the same state); the chains must divide over them.
    `progress_every=k` prints a progress line every k draws."""
    kernel = nuts_kernel(logdensity_fn, max_depth=max_depth)
    return _run(logdensity_fn, kernel, key, init_positions, num_warmup, num_samples, initial_step_size,
                target_accept, mesh, progress_every)


def run_hmc(
    logdensity_fn: Callable,
    key,
    init_positions,
    num_warmup: int = 500,
    num_samples: int = 1000,
    num_integration_steps: int = 32,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    mesh=None,
    progress_every: int | None = None,
) -> NUTSResult:
    """Multi-chain HMC with a fixed leapfrog length; arguments as `run_nuts`."""
    kernel = hmc_kernel(logdensity_fn, num_steps=num_integration_steps)

    def wrapped(gen, state, step_size, inv_mass, rows):
        state, info = kernel(gen, state, step_size[:, None], inv_mass, rows)
        return state, _HMCInfo(info["accept_prob"], ~info["accepted"], torch.zeros_like(step_size, dtype=torch.long))

    return _run(logdensity_fn, wrapped, key, init_positions, num_warmup, num_samples, initial_step_size,
                target_accept, mesh, progress_every)
