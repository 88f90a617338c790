"""Mapping one-chain user functions over the leading chain axis.

The reference writes a log-density, a factor or a forward model for one
chain and leaves the chains to ``vmap``. The port keeps those callables
one-chain, ``f(x (n,), **theta)``, and maps them with ``torch.func.vmap``
over x (B, n) and the θ entries of shape (B,); scalar θ entries are shared.
``torch.func`` transforms ignore an outer ``no_grad``, so the Laplace
mode's loop (which runs without autograd) can differentiate them, and
their outputs stay differentiable by ordinary autograd.
"""

from __future__ import annotations

import torch
from torch.func import vmap

__all__ = ["per_chain", "theta_tensors"]


def theta_tensors(theta) -> dict:
    """θ as a dict of tensors (Python numbers and arrays on the default
    device; None, a placeholder for a tensor, kept)."""
    from ._device import as_tensor

    return {k: v if v is None else as_tensor(v) for k, v in (theta or {}).items()}


def per_chain(f, x: torch.Tensor, theta: dict, *shared, event: int = 1):
    """f(x_b, theta_b, *shared) for each chain b: x (n,) or (B, n) (with
    `event` trailing axes in place of n's one), θ entries scalars or (B,);
    `shared` goes to every chain unchanged. One chain and scalar θ call f
    directly."""
    batch = torch.broadcast_shapes(x.shape[:x.ndim - event], *(v.shape for v in theta.values()))
    if batch == ():
        return f(x, theta, *shared)
    if len(batch) != 1:
        raise ValueError(f"one leading chain axis expected, got {batch}")
    xb = x.expand(batch + x.shape[x.ndim - event:])
    dims = {k: 0 if v.ndim else None for k, v in theta.items()}
    th = {k: v.expand(batch) if v.ndim else v for k, v in theta.items()}
    return vmap(f, in_dims=(0, dims) + (None,) * len(shared))(xb, th, *shared)
