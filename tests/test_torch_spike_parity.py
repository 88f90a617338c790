"""The three kernel functions of the port's SPIKE solve against the JAX
package's own, in float64 on the CPU, on the same NumPy inputs.

* `bt_factor_blocks` (K11's block entry) on one chain against
  ``tpu_gmrf.parallel.pbtridiag._bt_chol``: the factors L_k and M_k and the
  logdet 2 Σ log diag L_k, at K = 1 and 3 blocks (the reference computed
  once per shape, under ``jax.jit``).
* `bt_trsv_blocks` (K12's block entry) on one chain against
  ``tpu_gmrf.parallel.pbtridiag._bt_solve_factored``, both given the factors
  that the reference's ``_bt_chol`` computes for one random block-tridiagonal
  SPD matrix.
* `spike_reduced` (K18) at k = 1 against ``_reduced_solve``: the interface
  solution s and the logdet.

The sizes cross the kernels' tiles of 64 rows: blocks of 5, 64 and 65 rows,
k = 1, 3 and 65 right-hand sides, P = 1, 2 and 5 interface rows. Both sides
compute in float64 and differ only in rounding order: held to 1e-10 of the
largest entry (normwise) and the logdet to rtol 1e-12. On CPU tensors the
port runs each kernel's plain version; ``chip_smoke.py`` phase 3f holds the
kernels to those plain versions on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gmrf.parallel.pbtridiag import _bt_chol, _bt_solve_factored, _reduced_solve
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels

tg.set_default_device("cpu")

F64 = torch.float64
NORMWISE = 1e-10
LOGDET_RTOL = 1e-12


def _normwise(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= NORMWISE * np.abs(ref).max()


def _bt_spd(rng, K, s):
    """Diagonal blocks D (K, s, s), symmetric and dominant, and sub-diagonal blocks E (K-1, s, s)."""
    G = rng.normal(size=(K, s, s))
    D = G @ np.swapaxes(G, -1, -2) + 2.0 * s * np.eye(s)
    return D, 0.3 * rng.normal(size=(K - 1, s, s))


@functools.lru_cache(maxsize=None)
def _factor_case(s, K):
    """One SPD block-tridiagonal matrix of K blocks of s and the reference's factors of it (jitted)."""
    D, E = _bt_spd(np.random.default_rng(1000 + 10 * s + K), K, s)
    Lk, Mk = jax.jit(_bt_chol)(jnp.asarray(D), jnp.asarray(E))
    return D, E, np.asarray(Lk), np.asarray(Mk)


@pytest.mark.parametrize("s", [5, 64, 65])
@pytest.mark.parametrize("K", [1, 3])
def test_bt_factor_blocks_matches_reference(s, K):
    D, E, Lk, Mk = _factor_case(s, K)
    P, logdet = kernels.bt_factor_blocks(torch.tensor(D[None], dtype=F64), torch.tensor(E[None], dtype=F64))
    assert P.shape == (1, K, 2 * s, s)
    _normwise(P[0, :, :s].numpy(), Lk)
    if K > 1:
        _normwise(P[0, : K - 1, s:].numpy(), Mk)
    assert not P[0, K - 1, s:].any()  # no M after the last block
    ref_logdet = 2.0 * np.log(np.diagonal(Lk, axis1=-2, axis2=-1)).sum()
    np.testing.assert_allclose(logdet.item(), ref_logdet, rtol=LOGDET_RTOL)


@pytest.mark.parametrize("s", [5, 65])
@pytest.mark.parametrize("k", [1, 3, 65])
def test_bt_trsv_blocks_matches_reference(s, k):
    rng = np.random.default_rng(100 * s + k)
    K = 3
    D, E = _bt_spd(rng, K, s)
    Lk, Mk = (np.asarray(a) for a in _bt_chol(jnp.asarray(D), jnp.asarray(E)))
    b = rng.normal(size=(K, s, k))
    ref = np.asarray(_bt_solve_factored(jnp.asarray(Lk), jnp.asarray(Mk), jnp.asarray(b)))
    P = np.zeros((1, K, 2 * s, s))
    P[0, :, :s] = Lk
    P[0, : K - 1, s:] = Mk
    got = kernels.bt_trsv_blocks(torch.tensor(P, dtype=F64), torch.tensor(b[None], dtype=F64))
    _normwise(got[0].numpy(), ref)


@pytest.mark.parametrize("P", [1, 2, 5])
@pytest.mark.parametrize("ns", [5, 65])
def test_spike_reduced_matches_reference(P, ns):
    rng = np.random.default_rng(10 * P + ns)
    gamma = 0.3 * rng.normal(size=(P, ns, ns))
    G = rng.normal(size=(P, ns, ns))
    beta = G @ np.swapaxes(G, -1, -2) + 2.0 * ns * np.eye(ns)
    alpha = np.concatenate([np.zeros((1, ns, ns)), np.swapaxes(gamma[:-1], -1, -2)])
    r = rng.normal(size=(P, ns))
    ref_s, ref_logdet = (np.asarray(a) for a in _reduced_solve(*(jnp.asarray(a) for a in (alpha, beta, gamma, r))))
    s, logdet, _ = kernels.spike_reduced(*(torch.tensor(a, dtype=F64) for a in (alpha, beta, gamma, r[..., None])))
    _normwise(s[..., 0].numpy(), ref_s)
    np.testing.assert_allclose(logdet.item(), float(ref_logdet), rtol=LOGDET_RTOL)
