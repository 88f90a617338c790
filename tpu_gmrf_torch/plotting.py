"""Plotting recipes (matplotlib).

Counterpart of ``tpu_gmrf.plotting`` (reference src/plots/makie.jl +
ext/GaussianMarkovRandomFieldsMakie.jl:1-199): 1-D mean ± 1.96·std ribbons
with sample spaghetti, FEM surface fields on triangle meshes, and
per-time-slice panels for spatiotemporal GMRFs. matplotlib is imported
lazily, under the Agg backend, so the compute stack never depends on it.
Tensors are detached and copied to the host; a recipe plots one chain.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_1d", "plot_field", "plot_spatiotemporal"]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _one_chain(x, batch_dims: int, what: str) -> np.ndarray:
    """x with a leading chain axis of one dropped; more chains raise."""
    x = _numpy(x)
    if x.ndim > batch_dims:
        if x.ndim > batch_dims + 1 or x.shape[0] != 1:
            raise ValueError(f"{what}: plots one chain, got an array of shape {x.shape}; select a chain first")
        x = x[0]
    return x


def plot_1d(gmrf, x=None, n_samples: int = 3, generator: torch.Generator | None = None, ax=None, **kw):
    """Mean ± 1.96·std ribbon and optional posterior samples (drawn with
    `generator`) for a 1-D (chain-structured) GMRF."""
    plt = _plt()
    mean = _one_chain(gmrf.mean, 1, "plot_1d")
    std = _one_chain(gmrf.std(), 1, "plot_1d")
    if ax is None:
        _, ax = plt.subplots()
    if x is None:
        x = np.arange(mean.shape[0])
    ax.fill_between(x, mean - 1.96 * std, mean + 1.96 * std, alpha=0.3, label="95% CI")
    ax.plot(x, mean, label="mean", **kw)
    if n_samples and generator is not None:
        samps = _numpy(gmrf.sample(generator, (n_samples,))).reshape(n_samples, -1)
        for s in samps:
            ax.plot(x, s, alpha=0.4, lw=0.8)
    ax.legend()
    return ax


def plot_field(values, mesh=None, points=None, triangles=None, ax=None, **kw):
    """Scalar field on a triangle mesh (tripcolor). Accepts a TriangleMesh
    (fem.mesh) or raw points/triangles arrays."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    if mesh is not None:
        points = np.asarray(getattr(mesh, "vertices", getattr(mesh, "points", None)))
        triangles = np.asarray(mesh.triangles)
    points = _numpy(points)
    tc = ax.tripcolor(points[:, 0], points[:, 1], _numpy(triangles), _one_chain(values, 1, "plot_field"), **kw)
    plt.colorbar(tc, ax=ax)
    ax.set_aspect("equal")
    return ax


def plot_spatiotemporal(st_gmrf, times=None, ncols: int = 4, what: str = "mean", **kw):
    """Panel plot of time-slice means (or stds) of a SpatiotemporalGMRF."""
    plt = _plt()
    slices = _one_chain(st_gmrf.time_means() if what == "mean" else st_gmrf.time_stds(), 2, "plot_spatiotemporal")
    nt = slices.shape[0]
    idx = list(range(nt)) if times is None else list(times)
    nrows = -(-len(idx) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.5 * nrows), squeeze=False)
    disc = getattr(st_gmrf, "disc", None)
    for k, t in enumerate(idx):
        ax = axes[k // ncols][k % ncols]
        field = slices[t]
        if disc is not None and hasattr(disc, "mesh") and hasattr(disc.mesh, "triangles"):
            plot_field(field, mesh=disc.mesh, ax=ax, **kw)
        else:
            ax.plot(field)
        ax.set_title(f"t={t}")
    for k in range(len(idx), nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    fig.tight_layout()
    return fig
