"""The port's samplers breadth (`run_smc`, `run_advi`, `run_nuts_checkpointed`)
and its chains over several processes (`run_nuts`/`run_hmc`/`run_smc`/`run_advi`
with ``mesh=``, the `dryrun_multichip` twin), against the JAX package in
float64 on the CPU.

* `_ess` and `_systematic_resample` fed the uniform that the reference draws
  from its key: indices equal, ESS to 1e-13.
* `run_smc(max_stages=1)` from the same particles in both packages: λ₁ and
  the log evidence come before any random move, to 1e-12 relative.
* ADVI: the reference's noise, ``jax.random.normal(jax.random.split(key,
  num_steps)[t], (S, d))`` as ``vi.py:69,84`` draws it, fed through the port's
  `advi_step` from the reference's starting point for 25 steps: mean, log_std
  and the ELBO trace to 1e-10 of the reference's `run_advi`.
* The reference's statistical tests (``tests/test_samplers.py``) at their own
  tolerances on the port; a checkpointed run resumed equal to an
  uninterrupted one; ``run_advi(num_steps=0)``'s empty trace.
* Example 07: the CAR logpdf at the truth on JAX's draw (the golden value was
  computed without x64, so the draw is made under ``jax.enable_x64(False)``)
  equals 24.138412 within 1e-6, its (ρ, σ)-gradient ``jax.grad``'s to 1e-10;
  a short NUTS run for shapes and finiteness.
* Over ``torch.distributed`` (gloo) at world sizes 2 and 4, one spawn per world
  size meeting through a ``FileStore`` under tmp_path: `run_nuts` and `run_hmc`
  (8 chains, 4 + 4 draws), `run_smc` (16 particles) and `run_advi` (8 draws, 10
  steps) on AR1(16)'s Laplace marginal equal on every rank to the one-process
  run (ADVI's sums over the ranks change the summation order: 1e-12), the
  `dryrun_multichip` twin, and the ValueErrors for batches that do not divide.

Reference values are computed once per module.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.multiprocessing as mp
from _torch_mesh_worker import MESH_CHAINS, dist_worker, mesh_cases

from tpu_gmrf.models.car import generate_car_model as j_generate_car_model
from tpu_gmrf.samplers import run_advi as j_run_advi
from tpu_gmrf.samplers import run_smc as j_run_smc
from tpu_gmrf.samplers import smc as jsmc
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop
from tpu_gmrf_torch.multichip import dryrun_multichip
from tpu_gmrf_torch.samplers import smc as tsmc
from tpu_gmrf_torch.samplers.vi import adam, advi_step

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# ---- SMC's pieces against the reference ------------------------------------------------------


@pytest.mark.parametrize("scale", [0.1, 3.0, 30.0])
def test_ess_and_systematic_resample_match_reference(scale):
    n = 64
    lw = np.random.default_rng(int(scale * 10)).normal(scale=scale, size=n)
    key = jax.random.PRNGKey(5)
    u = float(jax.random.uniform(key))  # what the reference's _systematic_resample draws from `key`
    want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(lw), n))
    got = tsmc._systematic_resample(torch.tensor(u, dtype=F64), _t(lw), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert _rel(float(tsmc._ess(_t(lw))), float(jsmc._ess(jnp.asarray(lw)))) <= 1e-13


def _sharp(z):
    return -5.0 * (z * z).sum(-1)


def _counts(z):
    return (_t([3.0, 0.0]) * z - torch.exp(z)).sum(-1)


SMC_LIKS = {"sharp": (_sharp, lambda z: -5.0 * z @ z),
            "counts": (_counts, lambda z: jnp.sum(jnp.array([3.0, 0.0]) * z - jnp.exp(z)))}


@functools.lru_cache(maxsize=None)
def _smc_reference(name):
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (128, 2)), np.float64)
    res = j_run_smc(lambda z: -0.5 * z @ z, SMC_LIKS[name][1], jax.random.PRNGKey(1), jnp.asarray(init),
                    num_move_steps=1, hmc_num_steps=2, step_size=0.3, max_stages=1)
    return init, interop.smc_result_from_numpy(*(np.asarray(a) for a in res), device="cpu")


@pytest.mark.parametrize("name", sorted(SMC_LIKS))
def test_smc_first_stage_matches_reference(name):
    init, ref = _smc_reference(name)
    got = tg.run_smc(lambda z: -0.5 * (z * z).sum(-1), SMC_LIKS[name][0], 1, _t(init), num_move_steps=1,
                     hmc_num_steps=2, step_size=0.3, max_stages=1)
    assert got.num_stages == ref.num_stages == 1
    assert _rel(got.lambdas.numpy(), ref.lambdas.numpy()) <= 1e-12
    assert _rel(float(got.log_evidence), float(ref.log_evidence)) <= 1e-12
    if name == "sharp":
        assert float(ref.lambdas[0]) < 1.0  # the bisection ran


# ---- ADVI's trajectory under the reference's noise -------------------------------------------

ADVI = dict(steps=25, samples=6, lr=5e-2)
ADVI_MU, ADVI_PREC = np.array([2.0, -1.0, 0.5]), np.array([[2.0, 0.3, 0.0], [0.3, 0.5, 0.1], [0.0, 0.1, 1.0]])


def _advi_ld_jax(z):
    d = z - jnp.asarray(ADVI_MU)
    return -0.5 * d @ jnp.asarray(ADVI_PREC) @ d - 0.1 * jnp.sum(d**4)


def _advi_ld(z):
    d = z - _t(ADVI_MU)
    return -0.5 * ((d @ _t(ADVI_PREC)) * d).sum(-1) - 0.1 * (d**4).sum(-1)


@functools.lru_cache(maxsize=None)
def _advi_reference():
    key, init = jax.random.PRNGKey(3), jnp.array([0.5, 0.0, -0.5])
    res = j_run_advi(_advi_ld_jax, key, init, num_steps=ADVI["steps"], num_elbo_samples=ADVI["samples"],
                     learning_rate=ADVI["lr"])
    noise = [np.asarray(jax.random.normal(k, (ADVI["samples"], 3), init.dtype))
             for k in jax.random.split(key, ADVI["steps"])]
    return np.asarray(init), noise, interop.advi_result_from_numpy(*(np.asarray(a) for a in res), device="cpu")


def test_advi_matches_reference_under_the_same_noise():
    init, noise, ref = _advi_reference()
    start = interop.advi_result_from_numpy(init, np.full(3, -1.0), np.zeros(0), device="cpu")
    mean, log_std = start.mean.requires_grad_(), start.log_std.requires_grad_()
    opt = adam([mean, log_std], ADVI["lr"])
    elbos = [advi_step(_advi_ld, mean, log_std, opt, _t(eps)) for eps in noise]
    assert _rel(torch.stack(elbos).numpy(), ref.elbo_trace.numpy()) <= 1e-10
    assert _rel(mean.detach().numpy(), ref.mean.numpy()) <= 1e-10
    assert _rel(log_std.detach().numpy(), ref.log_std.numpy()) <= 1e-10


# ---- the reference's statistical tests on the port (tests/test_samplers.py) ------------------


def test_smc_gaussian_evidence():
    """Prior N(0, I), likelihood N(y; z, I) with y=0 → posterior N(0, I/2),
    evidence = N(0; 0, 2I)."""
    from scipy import stats

    dim, n_part = 2, 512

    def log_prior(z):
        return -0.5 * (z * z).sum(-1) - 0.5 * dim * np.log(2 * np.pi)

    init = torch.randn((n_part, dim), generator=torch.Generator().manual_seed(0), dtype=F64)
    res = tg.run_smc(log_prior, log_prior, 1, init, step_size=0.4)
    parts = res.particles.numpy()
    np.testing.assert_allclose(parts.mean(axis=0), np.zeros(dim), atol=0.12)
    np.testing.assert_allclose(parts.var(axis=0), 0.5 * np.ones(dim), rtol=0.25)
    ref_logZ = stats.multivariate_normal(mean=np.zeros(dim), cov=2 * np.eye(dim)).logpdf(np.zeros(dim))
    np.testing.assert_allclose(float(res.log_evidence), ref_logZ, atol=0.15)


def test_advi_gaussian():
    mu, var = np.array([2.0, -1.0]), np.array([0.5, 2.0])

    def ld(z):
        d = z - _t(mu)
        return -0.5 * (d * d / _t(var)).sum(-1)

    res = tg.run_advi(ld, 0, torch.zeros(2, dtype=F64), num_steps=3000)
    np.testing.assert_allclose(res.mean.numpy(), mu, atol=0.1)
    np.testing.assert_allclose(np.exp(2 * res.log_std.numpy()), var, rtol=0.2)
    draws = res.sample(torch.Generator().manual_seed(1), 4000)
    np.testing.assert_allclose(draws.mean(0).numpy(), mu, atol=0.1)


def test_advi_zero_steps_gives_an_empty_trace():
    res = tg.run_advi(lambda z: -0.5 * (z * z).sum(-1), 0, torch.zeros(2, dtype=F64), num_steps=0)
    assert res.elbo_trace.shape == (0,)
    np.testing.assert_array_equal(res.mean.numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(res.log_std.numpy(), [-1.0, -1.0])


def test_checkpointed_nuts(tmp_path):
    """Chunked NUTS with checkpoint/resume: the interrupted run resumes with
    identical first draws, equals an uninterrupted run, and its moments are sane."""
    dim = 2

    def ld(z):
        return -0.5 * (z * z).sum(-1)

    kw = dict(num_warmup=200, chunk_size=100)
    init = torch.zeros((2, dim), dtype=F64)
    d1 = str(tmp_path / "ck")
    samples, state = tg.run_nuts_checkpointed(ld, 0, init, checkpoint_dir=d1, num_samples=300, **kw)
    assert samples.shape == (2, 300, dim)
    # resume: ask for more samples — warmup must NOT re-run, and the first 300 draws are identical
    samples2, _ = tg.run_nuts_checkpointed(ld, 0, init, checkpoint_dir=d1, num_samples=500, **kw)
    assert samples2.shape == (2, 500, dim)
    np.testing.assert_array_equal(samples2[:, :300].numpy(), samples.numpy())
    whole, _ = tg.run_nuts_checkpointed(ld, 0, init, checkpoint_dir=str(tmp_path / "fresh"), num_samples=500, **kw)
    np.testing.assert_array_equal(samples2.numpy(), whole.numpy())
    np.testing.assert_allclose(samples2.reshape(-1, dim).mean(0).numpy(), np.zeros(dim), atol=0.2)
    assert set(state) == {"step_size", "inv_mass", "positions"}


# ---- example 07: NUTS over a CAR model -------------------------------------------------------

CAR_TRUTH = dict(rho=0.85, sigma=0.01)
CAR_GOLDEN = 24.138412  # tools/golden_values.py:224


@functools.lru_cache(maxsize=None)
def _car():
    """Example 07's W (21-point chain, 1/|k| weights at lags 1 and 2), JAX's
    draw at the truth and the reference's logpdf gradient in (ρ, σ) there."""
    N = 21
    rows, cols, vals = [], [], []
    for i in range(N):
        for k in (-2, -1, 1, 2):
            if 0 <= i + k < N:
                rows.append(i)
                cols.append(i + k)
                vals.append(1.0 / abs(k))
    W = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    with jax.enable_x64(False):  # the golden value's draw (examples run without x64)
        y = np.asarray(j_generate_car_model(W, 0.85, sigma=0.01).sample(jax.random.PRNGKey(123)), np.float64)
    grad = jax.jit(jax.grad(lambda th: j_generate_car_model(W, th[0], sigma=th[1]).logpdf(jnp.asarray(y))))(
        jnp.array([CAR_TRUTH["rho"], CAR_TRUTH["sigma"]]))
    return W, y, np.asarray(grad)


def test_example07_car_logpdf_and_gradient_on_jax_draw():
    W, y, want = _car()
    th = torch.tensor([CAR_TRUTH["rho"], CAR_TRUTH["sigma"]], dtype=F64, requires_grad=True)
    ll = tg.generate_car_model(W, th[0], sigma=th[1]).logpdf(_t(y))
    assert abs(ll.item() - CAR_GOLDEN) < 1e-6
    (g,) = torch.autograd.grad(ll, th)
    assert _rel(g.numpy(), want) <= 1e-10


def test_example07_short_nuts_run():
    W, y, _ = _car()
    spec = tg.ParamSpec(rho=(tg.LogitTransform(0.5, 0.99), lambda r: 0.0),
                        sigma=(tg.LogitTransform(0.001, 0.1), lambda s: 0.0))
    ld = tg.make_logdensity(lambda th: tg.generate_car_model(W, th["rho"], sigma=th["sigma"]).logpdf(_t(y)), spec)
    res = tg.run_nuts(ld, 456, torch.zeros(4, 2, dtype=F64), num_warmup=20, num_samples=20, max_depth=8)
    assert res.samples.shape == (4, 20, 2) and res.depth.shape == (4, 20)
    assert bool(torch.isfinite(res.samples).all()) and bool(torch.isfinite(res.logdensity).all())
    draws = spec.constrain(res.samples)
    assert bool(((draws["rho"] > 0.5) & (draws["rho"] < 0.99)).all())


# ---- over torch.distributed (gloo) -----------------------------------------------------------

@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """world -> every rank's results; one spawn per world size, run at first use."""
    done = {}

    def get(world):
        if world not in done:
            tmp = str(tmp_path_factory.mktemp(f"gloo{world}"))
            mp.spawn(dist_worker, args=(world, os.path.join(tmp, "store"), tmp), nprocs=world)
            done[world] = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
        return done[world]

    return get


@pytest.fixture(scope="module")
def one_process():
    return mesh_cases(None)


def _equal(got, want, tol: float = 0.0) -> None:
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if tol == 0.0 or not g.is_floating_point():
            assert torch.equal(g, w)
        else:
            assert _rel(g.numpy(), w.numpy()) <= tol


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["nuts", "hmc", "smc"])
def test_meshed_sampler_equals_one_process(dist_results, one_process, world, name):
    want = one_process[name]
    if name == "smc":
        assert want.num_stages == 3 and float(want.lambdas[0]) < 1.0
    for r in dist_results(world):
        _equal(r["cases"][name], want)  # bit for bit: each chain's arithmetic is the one-process chain's
    if name in ("nuts", "hmc"):
        assert want.depth.shape == (MESH_CHAINS, 4) and bool(torch.isfinite(want.samples).all())


@pytest.mark.parametrize("world", [2, 4])
def test_meshed_advi_equals_one_process(dist_results, one_process, world):
    want = one_process["advi"]
    assert want.elbo_trace.shape == (10,)
    for r in dist_results(world):
        _equal(r["cases"]["advi"], want, tol=1e-12)  # the sums over the ranks change the summation order


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip_twin(dist_results, world):
    ranks = dist_results(world)
    first = ranks[0]["dryrun"]
    assert first["nuts"].samples.shape == (world, 4, 2) and first["spike"]["x"].shape == (2 * world, 3)
    for r in ranks[1:]:  # every rank holds the whole result
        for part in ("nuts", "smc", "advi", "hmc"):
            _equal(r["dryrun"][part], first[part])
        assert torch.equal(r["dryrun"]["spike"]["x"], first["spike"]["x"])


def test_dryrun_multichip_twin_one_rank(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out = dryrun_multichip(init_device_mesh("cpu", (1,), mesh_dim_names=("chains",)))
    finally:
        dist.destroy_process_group()
    assert out["smc"].particles.shape == (4, 2) and out["advi"].elbo_trace.shape == (6,)


@pytest.mark.parametrize("world", [2, 4])
def test_meshed_batches_that_do_not_divide_raise(dist_results, world):
    for r in dist_results(world):
        errors = r["errors"]
        assert errors["nuts"] == f"num_chains={world + 1} must divide over {world} devices"
        assert errors["smc"] == f"num_particles {2 * world + 1} not divisible by mesh axis 'chains' ({world})"
        assert errors["advi"] == f"num_elbo_samples {world + 1} not divisible by mesh axis 'chains' ({world})"
