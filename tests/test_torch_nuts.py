"""The port's NUTS, adaptation and sampling driver against the JAX package.

The NUTS transition is compared with the same random draws: the test
rebuilds the reference kernel's draws from its key splits (``nuts.py:64,
127-131,141,158``) and hands them to `nuts_transition` as tensors. The
Laplace log-density runs with tight Newton tolerances, so both sides stop
at the converged mode and agree to rounding (1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf.samplers import adaptation as jad
from tpu_gmrf.samplers import hmc as jhmc
from tpu_gmrf.samplers import nuts as jnuts
from tpu_gmrf.samplers import run as jrun
from tpu_gmrf.samplers import transforms as jtr
from tpu_gmrf_torch import set_default_device
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop
from tpu_gmrf_torch.samplers import adaptation as tad
from tpu_gmrf_torch.samplers import hmc as thmc
from tpu_gmrf_torch.samplers import nuts as tnuts
from tpu_gmrf_torch.samplers import transforms as ttr

# these tests hold the plain versions (CPU tensors) against the JAX package
set_default_device("cpu")

F64 = torch.float64
MAX_DEPTH = 5


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=kw.pop("dtype", F64), **kw)


# ---- adaptation ----------------------------------------------------------------


def test_dual_averaging_and_welford_match_reference():
    rng = np.random.default_rng(0)
    B, d, steps = 5, 3, 12
    eps0 = rng.uniform(0.05, 0.5, size=B)
    acc = rng.uniform(size=(steps, B))
    xs = rng.normal(size=(steps, B, d))
    jda = jax.vmap(jad.da_init)(jnp.asarray(eps0))
    tda = tad.da_init(_t(eps0))
    jw = jax.vmap(lambda _: jad.welford_init(d, jnp.float64))(jnp.arange(B))
    tw = tad.welford_init(d, F64, (B,), "cpu")
    for i in range(steps):
        jda = jax.vmap(lambda s, a: jad.da_update(s, a, target=0.75))(jda, jnp.asarray(acc[i]))
        tda = tad.da_update(tda, _t(acc[i]), target=0.75)
        jw = jax.vmap(jad.welford_update)(jw, jnp.asarray(xs[i]))
        tw = tad.welford_update(tw, _t(xs[i]))
    ref = interop.da_state_from_numpy(*(np.asarray(a) for a in jda), device="cpu")
    for got, want in zip(tda, ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    for reg in (True, False):
        want = jax.vmap(lambda w: jad.welford_variance(w, regularize=reg))(jw)
        np.testing.assert_allclose(tad.welford_variance(tw, regularize=reg).numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    refw = interop.welford_state_from_numpy(*(np.asarray(a) for a in jw), device="cpu")
    for got, want in zip(tw, refw):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("num_warmup", [0, 1, 10, 100, 150, 151, 500, 1000])
def test_warmup_schedule_matches_reference(num_warmup):
    slow, end = tad.warmup_schedule(num_warmup)
    jslow, jend = jad.warmup_schedule(num_warmup)
    np.testing.assert_array_equal(slow, np.asarray(jslow))
    np.testing.assert_array_equal(end, np.asarray(jend))


# ---- the NUTS transition with the reference's draws -------------------------------


def _reference_draws(key, inv_mass, dim):
    """The draws of one reference `nuts_kernel` step from its key splits,
    as NUTSDraws fields for one chain (unused leaves 0.5)."""
    key_mom, key_tree = jax.random.split(key)
    mom = jax.random.normal(key_mom, (dim,), jnp.float64) * jnp.sqrt(1.0 / jnp.asarray(inv_mass))
    direction = np.zeros(MAX_DEPTH)
    accept = np.zeros(MAX_DEPTH)
    leaf = np.full((MAX_DEPTH, 2 ** (MAX_DEPTH - 1)), 0.5)
    k = key_tree
    for j in range(MAX_DEPTH):
        k, key_dir, key_sub, key_acc = jax.random.split(k, 4)
        # the reference's Bernoulli(½) as a uniform on the right side of ½
        direction[j] = 0.25 if bool(jax.random.bernoulli(key_dir)) else 0.75
        accept[j] = float(jax.random.uniform(key_acc))
        kk = key_sub
        for i in range(2**j):
            kk, key_prop = jax.random.split(kk)
            leaf[j, i] = float(jax.random.uniform(key_prop))
    return np.asarray(mom), direction, accept, leaf


def _gaussian():
    prec = np.linalg.inv(np.array([[1.0, 0.8], [0.8, 1.0]]))

    def jld(z):
        return -0.5 * z @ jnp.asarray(prec) @ z

    def tld(z):
        return -0.5 * ((z @ _t(prec)) * z).sum(-1)

    z0 = np.array([[0.5, -0.3], [1.2, 1.0], [-0.7, 0.2], [0.1, 0.1]])
    return jld, tld, z0, np.array([0.3, 0.25, 0.4, 25.0])


def _laplace():
    n = 30
    rng = np.random.default_rng(3)
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = 0.7 * x[i - 1] + rng.normal() * np.sqrt(1 - 0.49)
    y = rng.poisson(np.exp(np.clip(x, -3, 3))).astype(np.float64)
    opts = dict(max_iter=50, newton_dec_tol=1e-14, mean_change_tol=1e-12)
    js = jtr.ParamSpec(tau=(jtr.LogTransform(), lambda t: -0.5 * jnp.log(t) ** 2),
                       rho=(jtr.LogitTransform(-1.0, 1.0), lambda r: 0.0))
    ts = ttr.ParamSpec(tau=(ttr.LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
                       rho=(ttr.LogitTransform(-1.0, 1.0), lambda r: 0.0))
    jld = jtr.make_logdensity(
        lambda th: jg.laplace_marginal(jg.AR1Model(n), jg.ExponentialFamily("poisson"), y, th,
                                       options=jg.GAOptions(**opts)), js)
    tld = ttr.make_logdensity(
        lambda th: tg.laplace_marginal(tg.AR1Model(n), tg.ExponentialFamily("poisson"), y, th,
                                       options=tg.GAOptions(**opts)), ts)
    z0 = np.array([[0.2, 0.5], [-0.3, 1.0], [0.5, 0.0], [0.0, 0.8]])
    return jld, tld, z0, np.array([0.2, 0.15, 0.3, 40.0])


@pytest.mark.parametrize("target", ["gaussian", "laplace"])
def test_nuts_transition_matches_reference_with_the_same_draws(target):
    jld, tld, z0, step = (_gaussian if target == "gaussian" else _laplace)()
    B, d = z0.shape
    inv_mass = np.array([[1.0, 0.7], [0.5, 1.0], [1.0, 1.0], [1.0, 1.0]])
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    jstep = jnuts.nuts_kernel(jld, max_depth=MAX_DEPTH)

    def one(key, z, eps, im):
        return jstep(key, jhmc.hmc_init(jld, z), eps, im)

    jstate, jinfo = jax.jit(jax.vmap(one))(keys, jnp.asarray(z0), jnp.asarray(step), jnp.asarray(inv_mass))
    draws = [_reference_draws(keys[b], inv_mass[b], d) for b in range(B)]
    draws = tnuts.NUTSDraws(*(_t(np.stack(x)) for x in zip(*draws)))

    def run(idx):
        state = thmc.hmc_init(tld, _t(z0[idx]))
        sub = tnuts.NUTSDraws(*(x[idx] for x in draws))
        return tnuts.nuts_transition(tld, state, sub, _t(step[idx]), _t(inv_mass[idx]), MAX_DEPTH)

    tstate, tinfo = run(list(range(B)))
    np.testing.assert_array_equal(tinfo.depth.numpy(), np.asarray(jinfo.depth))
    np.testing.assert_array_equal(tinfo.num_leaves.numpy(), np.asarray(jinfo.num_leaves))
    np.testing.assert_array_equal(tinfo.diverging.numpy(), np.asarray(jinfo.diverging))
    assert bool(tinfo.diverging[-1]) and not tinfo.diverging[:-1].any()  # the last chain's step diverges
    for got, want in ((tstate.position, jstate.position), (tstate.logdensity, jstate.logdensity),
                      (tinfo.accept_prob, jinfo.accept_prob), (tinfo.energy, jinfo.energy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    # the diverging chain does not touch the others: without it they come out the same
    ostate, oinfo = run([0, 1, 2])
    torch.testing.assert_close(ostate.position, tstate.position[:3], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(oinfo.num_leaves, tinfo.num_leaves[:3])


def test_nuts_kernel_draws_from_a_generator():
    _, tld, z0, _ = _gaussian()
    step = tnuts.nuts_kernel(tld, max_depth=4)
    state = thmc.hmc_init(tld, _t(z0))
    out1, info1 = step(torch.Generator().manual_seed(3), state, 0.3, _t([1.0, 1.0]))
    out2, _ = step(torch.Generator().manual_seed(3), state, 0.3, _t([1.0, 1.0]))
    torch.testing.assert_close(out1.position, out2.position)
    assert (info1.depth >= 1).all() and (info1.depth <= 4).all()
    assert (info1.num_leaves >= 1).all() and (info1.num_leaves <= 2**info1.depth - 1).all()


def test_newton_nan_chain_leaves_the_others_alone():
    # a NaN θ in one chain exits that chain's Newton loop at once and must
    # not end or change the others' loops
    n = 20
    rng = np.random.default_rng(4)
    y = rng.poisson(2.0, size=n).astype(np.float64)
    model, obs = tg.AR1Model(n), tg.ExponentialFamily("poisson")
    tau, rho = np.array([1.0, np.nan, 2.0]), np.array([0.5, 0.3, -0.2])
    got = tg.laplace_marginal(model, obs, y, {"tau": _t(tau), "rho": _t(rho)})
    ok = tg.laplace_marginal(model, obs, y, {"tau": _t(tau[[0, 2]]), "rho": _t(rho[[0, 2]])})
    assert torch.isnan(got[1])
    torch.testing.assert_close(got[[0, 2]], ok, rtol=1e-12, atol=1e-12)


# ---- the driver ------------------------------------------------------------------


def test_run_nuts_gaussian_moments():
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    prec = _t(np.linalg.inv(cov))
    mean = _t([1.0, -2.0])

    def ld(z):
        dz = z - mean
        return -0.5 * ((dz @ prec) * dz).sum(-1)

    chains = 64
    init = np.random.default_rng(5).normal(size=(chains, 2))
    res = tg.run_nuts(ld, 7, _t(init), num_warmup=100, num_samples=100, max_depth=6)
    assert res.samples.shape == (chains, 100, 2) and res.depth.shape == (chains, 100)
    assert res.step_size.shape == (chains,) and res.inv_mass.shape == (chains, 2)
    assert not res.diverging.any()
    # per-chain moments; their spread across chains gives the Monte Carlo error
    m = res.samples.mean(1)
    v = res.samples.var(1)
    se_m = m.std(0) / np.sqrt(chains)
    se_v = v.std(0) / np.sqrt(chains)
    assert ((m.mean(0) - mean).abs() < 5 * se_m).all(), (m.mean(0), se_m)
    assert ((v.mean(0) - _t(np.diag(cov))).abs() < 5 * se_v).all(), (v.mean(0), se_v)


def test_run_hmc_and_result_fields_match_reference_layout(tmp_path):
    def jld(z):
        return -0.5 * jnp.sum(z**2)

    ref = jrun.run_nuts(jld, jax.random.PRNGKey(0), jnp.zeros((2, 3)), num_warmup=3, num_samples=4, max_depth=3)
    ref = interop.nuts_result_from_numpy(*(np.asarray(a) for a in ref), device="cpu")

    def ld(z):
        return -0.5 * (z**2).sum(-1)

    got = tg.run_nuts(ld, 0, torch.zeros(2, 3, dtype=F64), num_warmup=3, num_samples=4, max_depth=3)
    hmc = tg.run_hmc(ld, torch.Generator().manual_seed(0), torch.zeros(2, 3, dtype=F64), num_warmup=3,
                     num_samples=4, num_integration_steps=4)
    for res in (got, hmc):
        for a, b in zip(res, ref):
            assert a.shape == b.shape and a.dtype == b.dtype
    # mesh= (ported): over a one-rank process group the run is the one-process run
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("chains",))
        meshed = tg.run_nuts(ld, 0, torch.zeros(2, 3, dtype=F64), num_warmup=3, num_samples=4, max_depth=3,
                             mesh=mesh)
    finally:
        dist.destroy_process_group()
    for a, b in zip(meshed, got):
        assert torch.equal(a, b)


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    set_default_device("cuda")
    try:
        assert tg.default_device() == torch.device("cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            tg.AR1Model(8)(tau=1.0, rho=0.5)
    finally:
        set_default_device("cpu")
    # a tensor keeps its device
    gm = tg.AR1Model(8)(tau=torch.tensor(1.0, dtype=F64), rho=torch.tensor(0.5, dtype=F64))
    assert gm.Q.data.device.type == "cpu"
