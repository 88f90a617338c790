"""Second derivatives and forward mode of the Laplace marginal in the port,
against the JAX package in float64 on the same NumPy inputs (the plain
versions of the kernels, CPU tensors).

* The θ-Hessian of ``laplace_marginal`` (AR1(16) + Poisson at θ = (0.2, 0.3)
  in (log τ, atanh ρ), ``tests/test_inference.py:345-371``'s setup) by
  ``torch.autograd.functional.hessian``, through `NewtonMode`'s backward
  built with ``create_graph=True``, the logdet's (K19's plain version) and
  the solves', against ``jax.hessian`` of the reference: rtol 1e-5. The
  reference's own Hessian is asymmetric there by 1.4e-6 relative (1.68645481
  against 1.68645723): Newton's tolerance, so no test asks for more.
* Three chains at once equal three unbatched runs.
* Forward mode: example 13's objective (IID(50) + Poisson in (log τ, log μ);
  ``examples/13_automatic_differentiation.py``) by
  ``torch.autograd.forward_ad`` equals its reverse gradient and
  ``jax.jacfwd`` of the reference (1e-8); its Hessian is symmetric.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import speye as jspeye
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.sparse.matrix import speye

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
N = 16
P0 = np.array([0.2, 0.3])
HESS_RTOL = 1e-5


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


def _y():
    return np.random.default_rng(0).poisson(2.0, size=N).astype(np.float64)


def _ml_port(p):
    """laplace_marginal of AR1(N) + Poisson at θ = (log τ, atanh ρ); p (2,) or (B, 2)."""
    return tg.laplace_marginal(tg.AR1Model(N), tg.ExponentialFamily("poisson"), _y(),
                               {"tau": torch.exp(p[..., 0]), "rho": torch.tanh(p[..., 1])})


@functools.lru_cache(maxsize=None)
def _hessian_reference():
    y = _y()

    def ml(p):
        return jg.laplace_marginal(jg.AR1Model(N), jg.ExponentialFamily("poisson"), y,
                                   {"tau": jnp.exp(p[0]), "rho": jnp.tanh(p[1])})

    return np.asarray(jax.jit(jax.hessian(ml))(jnp.asarray(P0)))


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def test_laplace_marginal_hessian_matches_jax_hessian():
    want = _hessian_reference()
    assert abs(want[0, 1] - want[1, 0]) <= 2e-6 * abs(want[0, 1])  # the reference's Newton tolerance
    got = torch.autograd.functional.hessian(_ml_port, _t(P0)).numpy()
    assert _rel(got, want) <= HESS_RTOL
    assert abs(got[0, 1] - got[1, 0]) <= HESS_RTOL * abs(got[0, 1])


def test_batched_hessian_equals_unbatched_runs():
    """Chains stay apart: per-chain 2x2 Hessians of the summed marginal, by one
    gradient with create_graph=True and a backward pass per component."""
    ps = np.array([[0.2, 0.3], [-0.1, 0.6], [0.5, -0.2]])
    p = _t(ps, requires_grad=True)
    (g,) = torch.autograd.grad(_ml_port(p).sum(), p, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[:, i].sum(), p, retain_graph=True)[0] for i in range(2)], 1)
    for b in range(3):
        want = torch.autograd.functional.hessian(_ml_port, _t(ps[b]))
        np.testing.assert_allclose(H[b].numpy(), want.numpy(), rtol=1e-9, atol=1e-12)


# ---- forward mode: example 13 --------------------------------------------------------------

EX13_N, EX13_TAU, EX13_MU = 50, 4.0, 5.0


def _ex13_y():
    rng = np.random.default_rng(123)
    x_latent = EX13_MU + rng.normal(size=EX13_N) / np.sqrt(EX13_TAU)
    return rng.poisson(np.exp(np.clip(x_latent, -10, 10))).astype(np.float64)


def _ex13_theta():
    return np.array([np.log(EX13_TAU) + 0.2, np.log(EX13_MU) - 0.3])


def _objective(theta):
    """Example 13's negative Laplace marginal in (log τ, log μ), IID prior (tridiagonal backend)."""
    prior = tg.GMRF.from_precision(torch.exp(theta[1]).expand(EX13_N), speye(EX13_N, F64) * torch.exp(theta[0]))
    return -tg.marginal_loglikelihood(prior, tg.ExponentialFamily("poisson")(_ex13_y()))


def test_example13_forward_gradient_matches_reverse_and_jacfwd():
    y = _ex13_y()

    def ref(theta):
        prior = jg.GMRF.from_precision(jnp.full(EX13_N, jnp.exp(theta[1])), jspeye(EX13_N, jnp.float64)
                                       * jnp.exp(theta[0]))
        return -jg.marginal_loglikelihood(prior, jg.ExponentialFamily("poisson")(y))

    th = _ex13_theta()
    want = np.asarray(jax.jit(jax.jacfwd(ref))(jnp.asarray(th)))
    fwd = []
    for i in range(2):
        with fwAD.dual_level():
            out = _objective(fwAD.make_dual(_t(th), torch.eye(2, dtype=F64)[i]))
            fwd.append(float(fwAD.unpack_dual(out).tangent))
    t = _t(th, requires_grad=True)
    (rev,) = torch.autograd.grad(_objective(t), t)
    np.testing.assert_allclose(fwd, rev.numpy(), rtol=1e-8)
    np.testing.assert_allclose(fwd, want, rtol=1e-8)
    H = torch.autograd.functional.hessian(_objective, _t(th)).numpy()
    assert abs(H[0, 1] - H[1, 0]) <= 1e-6 * abs(H).max()
