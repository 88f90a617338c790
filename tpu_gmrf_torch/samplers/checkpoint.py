"""Checkpoint and resume for long sampling runs.

Counterpart of ``tpu_gmrf.samplers.checkpoint``. Warmup runs through
`run_nuts` (one retained draw); sampling then goes in chunks of
`chunk_size` transitions, and after each chunk the whole state is written:
positions, step sizes, inverse masses, the draw count, every sample so far
and the generator's state. The file is written to a temporary name and moved
over the last one with ``os.replace``, so a crash leaves the previous chunk's
state whole; it is a ``torch.save`` of tensors and numbers, loaded with
``weights_only=True`` (no pickle; the reference uses orbax). A chunk runs
only the transitions it keeps, and every transition draws the same numbers
from the one generator whatever the chunking, so an interrupted run that
is resumed returns the samples of an uninterrupted one.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from .._device import as_tensor
from .hmc import hmc_init
from .nuts import nuts_kernel
from .run import _generator, run_nuts

__all__ = ["run_nuts_checkpointed"]

_STATE = "nuts_state.pt"


def _save(path: str, state: dict) -> None:
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def run_nuts_checkpointed(
    logdensity_fn: Callable,
    key,
    init_positions,
    checkpoint_dir: str,
    num_warmup: int = 500,
    num_samples: int = 1000,
    chunk_size: int = 200,
    max_depth: int = 10,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
):
    """Multi-chain NUTS with chunked sampling and resumable checkpoints.

    If `checkpoint_dir` holds a state, sampling resumes from it (warmup is
    not repeated). `key` is a torch.Generator or an int seed. Returns
    (samples (chains, num_samples, dim), {"step_size", "inv_mass",
    "positions"})."""
    z = as_tensor(init_positions)
    z = z[None] if z.ndim == 1 else z
    dev = z.device
    kernel = nuts_kernel(logdensity_fn, max_depth=max_depth)
    path = os.path.join(checkpoint_dir, _STATE)
    if os.path.exists(path):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        positions, step_size, inv_mass, samples = (saved[k].to(dev) for k in
                                                   ("positions", "step_size", "inv_mass", "samples"))
        drawn = int(saved["drawn"])
        gen = torch.Generator(device=dev)
        gen.set_state(saved["generator"])
    else:
        gen = _generator(key, dev)
        warm = run_nuts(logdensity_fn, gen, z, num_warmup=num_warmup, num_samples=1, max_depth=max_depth,
                        initial_step_size=initial_step_size, target_accept=target_accept)
        positions, step_size, inv_mass = warm.samples[:, -1], warm.step_size, warm.inv_mass
        samples = positions.new_zeros(positions.shape[0], 0, positions.shape[1])
        drawn = 0
    while drawn < num_samples:
        take = min(chunk_size, num_samples - drawn)
        state = hmc_init(logdensity_fn, positions)
        xs = []
        for _ in range(take):
            state, _ = kernel(gen, state, step_size, inv_mass)
            xs.append(state.position)
        positions = state.position
        samples = torch.cat([samples, torch.stack(xs, 1)], 1)
        drawn += take
        os.makedirs(checkpoint_dir, exist_ok=True)
        _save(path, {"positions": positions.cpu(), "step_size": step_size.cpu(), "inv_mass": inv_mass.cpu(),
                     "drawn": drawn, "samples": samples.cpu(), "generator": gen.get_state()})
    return samples[:, :num_samples], {"step_size": step_size, "inv_mass": inv_mass, "positions": positions}
