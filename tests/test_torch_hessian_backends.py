"""The Laplace marginal's θ-Hessian on the general direct backends and with a
non-Gaussian prior, against the JAX package in float64 on the same NumPy
inputs (the plain versions of the kernels, CPU tensors).

* A GMRF prior Q(θ) = e^θ₀ (R + e^θ₁ I), R the graph Laplacian of a 5 x 5
  grid, with Poisson counts, through `marginal_loglikelihood` on the dense,
  banded (4 blocks of 8) and supernodal backends: the Hessian in θ by
  ``torch.autograd.functional.hessian`` against central differences
  (ε = 1e-5) of the reference's jitted ``jax.grad`` (its dense backend),
  rtol 1e-5 (Newton's tolerance on both sides).
* The Student-t random walk of ``tests/test_torch_nongaussian.py`` (n = 20,
  Poisson counts) through `NewtonModeNL`'s backward built with
  ``create_graph=True``: d²/d(log τ)² against a central difference
  (ε = 1e-5) of the reference's jitted ``jax.grad``, rtol 1e-5 (a
  ``jax.hessian`` of this marginal takes the reference half a minute to
  compile on a CPU; ``tests/test_torch_second_derivatives.py`` holds the
  port to one at AR1(16)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern
from tests.test_torch_nongaussian import _poisson_y, _rw_prior

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
G = 5
P0 = np.array([0.3, -0.4])
EPS, RTOL = 1e-5, 1e-5


def _grid():
    """The 5 x 5 grid Laplacian's pattern (diagonal included) and its values."""
    n = G * G
    idx = np.arange(n).reshape(G, G)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
                            np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1)])
    rows = np.concatenate([np.arange(n), pairs[:, 0], pairs[:, 1]])
    cols = np.concatenate([np.arange(n), pairs[:, 1], pairs[:, 0]])
    deg = np.bincount(pairs.ravel(), minlength=n).astype(np.float64)
    vals = np.concatenate([deg, -np.ones(len(pairs)), -np.ones(len(pairs))])
    pat = JP(rows, cols, (n, n))
    return pat, vals[pat.sort_order], (pat.rows == pat.cols).astype(np.float64)


def _y():
    return np.random.default_rng(50).poisson(1.5, size=G * G).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _grid_reference():
    pat, R, eye = _grid()
    y = _y()

    def ml(th):
        Q = JSM(jnp.exp(th[0]) * (jnp.asarray(R) + jnp.exp(th[1]) * jnp.asarray(eye)), pat)
        prior = jg.GMRF.from_precision(jnp.zeros(G * G), Q, jg.SolverSpec(kind="dense"))
        return jg.marginal_loglikelihood(prior, jg.ExponentialFamily("poisson")(y))

    g = jax.jit(jax.grad(ml))
    cols = [(np.asarray(g(jnp.asarray(P0 + EPS * e))) - np.asarray(g(jnp.asarray(P0 - EPS * e)))) / (2 * EPS)
            for e in np.eye(2)]
    return np.stack(cols, 1)


@pytest.mark.parametrize("kind", ["dense", "banded", "supernodal"])
def test_laplace_hessian_on_the_general_backends_matches_jax_differences(kind):
    pat_j, R, eye = _grid()
    pat = SparsePattern(pat_j.rows, pat_j.cols, pat_j.shape)
    spec = tg.SolverSpec(kind=kind)
    y = _y()

    def ml(th):
        Q = SparseMatrix(torch.exp(th[0]) * (torch.tensor(R) + torch.exp(th[1]) * torch.tensor(eye)), pat)
        prior = tg.GMRF.from_precision(torch.zeros(G * G, dtype=F64), Q, spec)
        return tg.marginal_loglikelihood(prior, tg.ExponentialFamily("poisson")(y),
                                         options=tg.GAOptions(inner_solver=spec))

    got = torch.autograd.functional.hessian(ml, torch.tensor(P0)).numpy()
    want = _grid_reference()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_nongaussian_prior_hessian_matches_jax_hessian():
    n, lt0 = 20, 0.2
    y = _poisson_y(n, 3)

    def jml(lt):
        return jg.marginal_loglikelihood(_rw_prior(jg, n, lt), jg.ExponentialFamily("poisson")(y))

    jgrad = jax.jit(jax.grad(jml))
    want = (float(jgrad(jnp.asarray(lt0 + EPS))) - float(jgrad(jnp.asarray(lt0 - EPS)))) / (2 * EPS)
    lt = torch.tensor(lt0, dtype=F64, requires_grad=True)
    v = tg.marginal_loglikelihood(_rw_prior(tg, n, lt), tg.ExponentialFamily("poisson")(y))
    (g,) = torch.autograd.grad(v, lt, create_graph=True)
    (h,) = torch.autograd.grad(g, lt)
    assert abs(float(h) - want) <= RTOL * abs(want)
