"""Port parity: NUTS and the hybrid model's posterior
(`hybrid_ode_torch/inference/mcmc.py`), its diagnostics and persistence, and
the CLI's `--mcmc`.

The JAX package vmaps one chain's NUTS loop over the chains; the port writes
the chain axis out. One transition is held to the JAX package's `_nuts_step`
chain by chain, in float64, with JAX's random draws replayed (momentum, then
per loop iteration the direction bit and two uniforms of its key schedule):
q and the accept statistic to 1e-10, the leapfrog count and the divergence
flag equal, on a correlated Gaussian (step sizes from U-turning to diverging)
and on the FAST hybrid model's log-posterior. A batched transition equals
each chain run alone (bitwise). The leapfrog, energy, U-turn and dual
averaging primitives: 1e-12 in f64. The fused chain log-posterior and
gradient (the fused RK4 kernels' plain versions, 'abs' context rows) against
the JAX package's `_make_fused_chain_logp` (Pallas interpret mode) and the
port's generic engine: 1e-5 (1 + |v|), the JAX suite's fused-vs-XLA limit.
The dense-mass Hessian against `jax.hessian` in f64: 1e-8 relative. The
diagnostics on the same arrays: 1e-12. Results files cross-read bitwise.
`nuts_sample` on Gaussians under the JAX suite's own limits
(`tests/test_inference.py`).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from hybrid_ode_tpu.inference import mcmc as jmcmc
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.inference import mcmc as tmcmc
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import cli as tcli
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "4gi_dataset.csv")
FAST = jhyb.HybridConfig(solver="rk4", substeps=2, nn_hidden=8, nn_layers=2, mode="scan")
SIGMA6 = np.array([0.5, 3.0, 2.0, 1.0, 0.3, 0.2])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _tcfg(cfg):
    import dataclasses

    return thyb.HybridConfig(**dataclasses.asdict(cfg))


def _params(cfg=FAST, dtype=np.float32, seed=0):
    p = jax.tree_util.tree_map(np.array, jhyb.init_hybrid_params(jax.random.PRNGKey(seed), cfg))
    last = f"w{cfg.nn_layers}"
    p["nn"][last] = 0.05 * np.random.default_rng(seed).normal(size=p["nn"][last].shape)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), p)


def _batch(B=3, T=6, dtype=np.float32, seed=2, extra=()):
    rng = np.random.default_rng(seed)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2])
    y0 = np.abs(base * (1 + 0.05 * rng.normal(size=(B, 6))))
    obs = base * (1 + 0.02 * rng.normal(size=(B, T, 6)))
    ext = {"meal": np.where(rng.uniform(size=(B, T)) > 0.6, 1.0, 0.0),
           "tVNS": rng.uniform(0, 0.5, (B, T))}
    ext.update({k: np.zeros((B, T)) for k in extra})
    mask = np.ones((B, T))
    mask[0, 2] = 0.0
    b = {"initial_state": y0, "observations": obs, "mask": mask,
         "time_points": np.broadcast_to(np.linspace(0.0, 1.0, T), (B, T)).copy(),
         "external_inputs": ext}
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), b)


def _jax_logp(monkeypatch, params, batch, cfg, **kw):
    """The JAX package's single-chain log-posterior of `run_nuts` (and its
    flat start), taken from the call to `nuts_sample`, which is not run."""
    got = {}

    def spy(logp_fn, q_init, key, **k):
        got.update(logp=logp_fn, q_init=np.asarray(q_init))
        C, dim = q_init.shape
        return {"samples": np.zeros((C, 1, dim)), "accept_stat": np.zeros((1, C)),
                "diverging": np.zeros((1, C), bool), "step_size": np.zeros(C)}

    monkeypatch.setattr(jmcmc, "nuts_sample", spy)
    jmcmc.run_nuts(params, batch, cfg, n_chains=2, num_samples=1, num_warmup=1, **kw)
    return got


class ReplayDraws:
    """A draw source of given arrays: momentum (C, dim), and per chain its
    own sequence of (bit, u, u) iterations, advanced only while it is active
    (as a chain's key is in the JAX package's vmapped loop)."""

    def __init__(self, p0, iters):
        self.p0, self.iters = np.asarray(p0), iters
        self.pos = np.zeros(len(iters), int)

    def momentum(self, n_chains, dim, dtype):
        return torch.tensor(self.p0, dtype=dtype)

    def iteration(self, active):
        rows = []
        for c, a in enumerate(active.tolist()):
            rows.append(self.iters[c][self.pos[c]] if a else (True, 0.5, 0.5))
            self.pos[c] += int(a)
        bits, u1, u2 = zip(*rows)
        return (torch.tensor(bits), torch.tensor(u1, dtype=torch.float64),
                torch.tensor(u2, dtype=torch.float64))


def _jax_draws(keys, dim, max_depth):
    """JAX's draws for chains with `keys`: `key, pkey = split(key)`, momentum
    normal(pkey, (dim,)); per iteration `key, dkey, uk, mkey = split(key, 4)`,
    bernoulli(dkey), uniform(uk), uniform(mkey)."""
    p0, iters = [], []
    for k in keys:
        k, pk = jax.random.split(k)
        p0.append(np.asarray(jax.random.normal(pk, (dim,))))
        its = []
        for _ in range(2 ** max_depth):
            k, dk, uk, mk = jax.random.split(k, 4)
            its.append((bool(jax.random.bernoulli(dk)), float(jax.random.uniform(uk)),
                        float(jax.random.uniform(mk))))
        iters.append(its)
    return ReplayDraws(np.stack(p0), iters)


def _transitions_match(jlogp, tlogp_and_grad, q0, eps, inv_mass, max_depth, seed):
    """One JAX transition per chain against one port transition of all."""
    keys = list(jax.random.split(jax.random.PRNGKey(seed), len(q0)))
    step = jax.jit(lambda q, k, e: jmcmc._nuts_step(jax.value_and_grad(jlogp), q, k, e,
                                                    jnp.asarray(inv_mass), max_depth))
    ref = [step(jnp.asarray(q0[c]), keys[c], jnp.asarray(eps[c])) for c in range(len(q0))]
    q, acc, nlf, div = tmcmc._nuts_step(tlogp_and_grad, torch.tensor(q0),
                                        _jax_draws(keys, q0.shape[1], max_depth),
                                        torch.tensor(eps), torch.tensor(inv_mass), max_depth)
    for c, (jq, ja, jn, jd) in enumerate(ref):
        assert _rel(jq, q[c]) < 1e-10, c
        assert abs(float(ja) - float(acc[c])) < 1e-10, c
        assert int(jn) == int(nlf[c]) and bool(jd) == bool(div[c]), (c, int(jn), int(nlf[c]))
    return nlf.numpy(), div.numpy()


COV3 = np.array([[1.0, 0.8, 0.1], [0.8, 2.0, -0.3], [0.1, -0.3, 0.5]])


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def test_leapfrog_energy_turning_and_dual_averaging_match_jax(x64):
    rng = np.random.default_rng(0)
    C, dim = 5, 4
    prec = np.diag([1.0, 2.0, 0.5, 3.0]) + 0.1
    q, p, qb, pb = (rng.normal(size=(C, dim)) for _ in range(4))
    eps, inv_mass = rng.uniform(0.05, 0.5, C), rng.uniform(0.5, 2.0, dim)
    lg = jax.value_and_grad(lambda x: -0.5 * x @ jnp.asarray(prec) @ x + jnp.sum(jnp.sin(x)))
    P = torch.tensor(prec)

    def tlg(Q):
        return -0.5 * ((Q @ P) * Q).sum(-1) + torch.sin(Q).sum(-1), -(Q @ P) + torch.cos(Q)

    tq, tm = torch.tensor(q), torch.tensor(inv_mass)
    logp, grad = tlg(tq)
    ts = tmcmc._leapfrog(tlg, tmcmc._LFState(tq, torch.tensor(p), grad, logp),
                         torch.tensor(eps), tm)
    turning = tmcmc._is_turning(tq, torch.tensor(p), torch.tensor(qb), torch.tensor(pb), tm)
    for c in range(C):
        lp, g = lg(jnp.asarray(q[c]))
        js = jmcmc._leapfrog(lg, jmcmc._LFState(jnp.asarray(q[c]), jnp.asarray(p[c]), g, lp),
                             eps[c], jnp.asarray(inv_mass))
        for a, b in zip(js, ts):
            assert _rel(a, b[c]) < 1e-12
        assert _rel(jmcmc._energy(js, inv_mass), tmcmc._energy(ts, tm)[c]) < 1e-12
        assert bool(jmcmc._is_turning(q[c], p[c], qb[c], pb[c], inv_mass)) == bool(turning[c])
    assert turning.any() and not turning.all()
    jdas = [jmcmc._da_init(0.1) for _ in range(C)]
    tda = tmcmc._da_init(torch.full((C,), 0.1, dtype=torch.float64))
    for astat in rng.uniform(0, 1, (3, C)):
        tda = tmcmc._da_update(tda, torch.tensor(astat), 0.8)
        jdas = [jmcmc._da_update(d, a, 0.8) for d, a in zip(jdas, astat)]
        for field in range(5):
            assert _rel([float(d[field]) for d in jdas], tda[field]) < 1e-12


def test_one_transition_matches_jax_on_a_gaussian(x64):
    """Step sizes from small (deep trees, U-turns) to large (divergences)."""
    prec = np.linalg.inv(COV3)
    mu = np.array([1.0, -1.0, 0.5])

    def jlogp(q):
        d = q - mu
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tlg(Q):
        d = Q - torch.tensor(mu)
        g = -(d @ torch.tensor(prec))
        return 0.5 * (g * d).sum(-1), g

    q0 = np.random.default_rng(1).normal(size=(8, 3))
    eps = np.array([0.02, 0.1, 0.3, 0.6, 0.9, 1.4, 2.5, 40.0])
    nlf, div = _transitions_match(jlogp, tlg, q0, eps, np.array([1.0, 0.5, 2.0]), 5, seed=3)
    assert nlf.max() > 8 and nlf.min() < 4 and div.any() and not div.all()


def test_one_transition_matches_jax_on_the_hybrid_posterior(x64, monkeypatch):
    p, batch = _params(dtype=np.float64), _batch(dtype=np.float64)
    jlogp = _jax_logp(monkeypatch, p, batch, FAST, noise_sigma=SIGMA6)["logp"]
    post = tmcmc.posterior(params_from_numpy(p, "cpu", torch.float64),
                           tdata.batch_to_tensors(batch, "cpu"), _tcfg(FAST), "xla", SIGMA6)
    rng = np.random.default_rng(4)
    q0 = post.q0.numpy()[None] * (1 + 0.02 * rng.normal(size=(4, 7)))
    _transitions_match(jlogp, post.logp_and_grad, q0, np.array([2e-4, 1e-3, 4e-3, 1e-2]),
                       np.ones(7), 3, seed=5)


def test_a_batched_transition_equals_each_chain_alone():
    """A chain's carry stops where it stops alone: same q, accept statistic,
    leapfrog count and divergence, bit for bit, from its own draws."""
    w = torch.tensor([1.0, 4.0, 0.25], dtype=torch.float64)

    def tlg(Q):
        return -0.5 * (w * Q * Q).sum(-1) - 0.05 * (Q ** 4).sum(-1), -w * Q - 0.2 * Q ** 3

    rng = np.random.default_rng(6)
    C, depth = 7, 5
    q0 = rng.normal(size=(C, 3))
    eps = np.array([0.05, 0.2, 0.4, 0.8, 1.1, 1.6, 30.0])
    p0 = rng.normal(size=(C, 3))
    iters = [[(bool(rng.uniform() < 0.5), rng.uniform(), rng.uniform())
              for _ in range(2 ** depth)] for _ in range(C)]
    inv_mass = torch.tensor([1.0, 0.3, 2.0], dtype=torch.float64)
    allc = tmcmc._nuts_step(tlg, torch.tensor(q0), ReplayDraws(p0, iters), torch.tensor(eps),
                            inv_mass, depth)
    for c in range(C):
        one = tmcmc._nuts_step(tlg, torch.tensor(q0[c:c + 1]), ReplayDraws(p0[c:c + 1], iters[c:c + 1]),
                               torch.tensor(eps[c:c + 1]), inv_mass, depth)
        for a, b in zip(allc, one):
            assert torch.equal(a[c], b[0]), c
    assert len(set(allc[2].tolist())) > 2 and allc[3].any()


def test_nuts_sample_on_gaussians_within_the_jax_suites_limits():
    """tests/test_inference.py::test_nuts_standard_normal and
    ::test_nuts_correlated_gaussian, their sizes and limits."""
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((16, 2), generator=gen)
    out = tmcmc.nuts_sample(lambda Q: -0.5 * (Q ** 2).sum(-1), q0, gen, num_samples=400,
                            num_warmup=200, max_depth=5)
    s = out["samples"].reshape(-1, 2)
    assert abs(s.mean()) < 0.1 and abs(s.var() - 1.0) < 0.15
    assert out["diverging"].mean() < 0.01
    for i in range(2):
        assert tmcmc.split_rhat(out["samples"][:, :, i]) < 1.05
    assert out["accept_stat"].shape == out["n_leapfrog"].shape == (400, 16)
    assert out["step_size"].shape == (16,) and out["inv_mass"].shape == (2,)

    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    prec, mu = torch.tensor(np.linalg.inv(cov), dtype=torch.float32), torch.tensor([1.0, -1.0])
    gen = torch.Generator().manual_seed(1)

    def logp(Q):
        d = Q - mu
        return -0.5 * ((d @ prec) * d).sum(-1)

    out = tmcmc.nuts_sample(logp, torch.randn((16, 2), generator=gen), gen, num_samples=500,
                            num_warmup=300, max_depth=6)
    s = out["samples"].reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), mu.numpy(), atol=0.12)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.35)


# ---------------------------------------------------------------------------
# the hybrid model's posterior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include_nn", [False, "last", True])
def test_flat_layout_is_ravel_pytrees(include_nn):
    """Sorted names: 'nn_b2' < 'nn_w2' < 'ode_E_max' < ... < 'ode_rho'."""
    p = _params()
    base = {f"ode_{n}": p["ode"][n] for n in jmcmc.ODE_PARAM_PRIORS}
    if include_nn == "last":
        base.update(nn_w2=p["nn"]["w2"], nn_b2=p["nn"]["b2"])
    elif include_nn:
        base.update({f"nn_{k}": v for k, v in p["nn"].items()})
    q, unravel = ravel_pytree(base)
    layout = tmcmc.FlatLayout({k: torch.as_tensor(v) for k, v in base.items()})
    np.testing.assert_array_equal(np.asarray(q), layout.ravel(
        {k: torch.as_tensor(v) for k, v in base.items()}).numpy())
    index = unravel(jnp.arange(q.size, dtype=jnp.float32))
    for name in base:
        np.testing.assert_array_equal(np.asarray(index[name]).astype(int), layout.index(name))
    back = layout.unravel(torch.as_tensor(np.stack([np.asarray(q)] * 2)))
    for name, v in base.items():
        assert back[name].shape == (2,) + np.shape(v)
        np.testing.assert_array_equal(back[name][1].numpy(), v)


def _logp_limit(ref, got):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
                        / (1.0 + np.abs(np.asarray(ref, np.float64)))))


def test_fused_chain_logp_matches_jax_and_the_generic_engine():
    """Chain c, window b on lane c*B + b of one fused call with the chains'
    7 ODE parameters as 'abs' context rows: value and gradient (autograd
    through the adjoint's dctx, summed per chain and scattered into q, plus
    the prior) against JAX's `_make_fused_chain_logp` under jax.vjp and
    against the port's generic engine."""
    p, batch = _params(), _batch()
    tp, tb = params_from_numpy(p, "cpu"), tdata.batch_to_tensors(batch, "cpu")
    sigma = SIGMA6.astype(np.float32)
    fused = tmcmc.posterior(tp, tb, _tcfg(FAST), "fused", sigma)
    generic = tmcmc.posterior(tp, tb, _tcfg(FAST), "xla", sigma)
    rng = np.random.default_rng(8)
    Q = (fused.q0.numpy()[None] * (1 + 0.1 * rng.normal(size=(5, 7)))).astype(np.float32)
    names = [f"ode_{n}" for n in jmcmc.ODE_PARAM_PRIORS]
    base = {n: p["ode"][n[4:]] for n in names}
    q, unravel = ravel_pytree(base)
    template = {k: np.asarray(v) for k, v in unravel(jnp.arange(q.size, dtype=jnp.float32)).items()}
    jlogp = jmcmc._make_fused_chain_logp(
        jax.tree_util.tree_map(jnp.asarray, p), batch, FAST, jhyb.controls_from_batch(batch),
        names, template, jnp.asarray(sigma))
    vals, pull = jax.vjp(jlogp, jnp.asarray(Q))
    (grads,) = pull(jnp.ones_like(vals))
    for post in (fused, generic):
        tv, tg = post.logp_and_grad(torch.as_tensor(Q))
        assert _logp_limit(vals, tv) < 1e-5 and _logp_limit(grads, tg) < 1e-5
    tv, tg = fused.logp_and_grad(torch.as_tensor(Q))
    gv, gg = generic.logp_and_grad(torch.as_tensor(Q))
    assert _logp_limit(gv, tv) < 1e-5 and _logp_limit(gg, tg) < 1e-5


def test_run_nuts_last_layer_with_a_vector_noise_matches_jax(monkeypatch):
    """include_nn='last' and a per-state noise: the port's log-posterior at
    the JAX package's chain starts equals JAX's (f32: 1e-5 (1 + |v|)); the
    port's run returns JAX's keys and shapes."""
    p, batch = _params(), _batch()
    got = _jax_logp(monkeypatch, p, batch, FAST, noise_sigma=SIGMA6, include_nn="last")
    post = tmcmc.posterior(params_from_numpy(p, "cpu"), batch, _tcfg(FAST), "xla", SIGMA6,
                           include_nn="last")
    assert post.layout.dim == got["q_init"].shape[1] == 7 + 8 * 6 + 6
    ref = [float(got["logp"](jnp.asarray(q))) for q in got["q_init"]]
    gv, _ = post.logp_and_grad(torch.tensor(got["q_init"]))
    assert _logp_limit(ref, gv) < 1e-5
    out = tmcmc.run_nuts(params_from_numpy(p, "cpu"), batch, _tcfg(FAST),
                         torch.Generator().manual_seed(0), num_samples=3, num_warmup=2,
                         n_chains=2, max_depth=2, noise_sigma=SIGMA6, include_nn="last")
    assert out["nn_w2"].shape == (6, 8, 6) and out["nn_b2"].shape == (6, 6)
    assert out["ode_a_GI"].shape == (6,) and out["_accept_stat"].shape == (3, 2)
    assert out["_diverging"].shape == (3, 2) and out["_step_size"].shape == (2,)
    assert all(np.isfinite(v).all() for v in out.values())


def test_dense_mass_hessian_matches_jax(x64, monkeypatch):
    """The 7 x 7 Hessian of the log-posterior at the params, reverse over
    reverse through the plain solver, against jax.hessian: 1e-8."""
    p, batch = _params(dtype=np.float64), _batch(dtype=np.float64)
    cfg = jhyb.HybridConfig(**{**FAST.__dict__, "use_pallas": True})
    seen = {}
    real = jax.hessian

    class Seen(Exception):
        pass

    def spy(f):
        def h(x):
            seen["H"] = np.asarray(real(f)(x))
            raise Seen  # the Hessian is all this test needs
        return h

    monkeypatch.setattr(jax, "hessian", spy)
    with pytest.raises(Seen):
        jmcmc.run_nuts(p, batch, cfg, n_chains=1, num_samples=1, num_warmup=1,
                       dense_mass=True, noise_sigma=SIGMA6)
    monkeypatch.undo()
    post = tmcmc.posterior(params_from_numpy(p, "cpu", torch.float64),
                           tdata.batch_to_tensors(batch, "cpu"), _tcfg(cfg), "xla", SIGMA6)
    idx = np.array([int(post.layout.index(n)) for n in post.sample_names])
    A, H = tmcmc._dense_whitening(lambda q: post.logp(q[None])[0], post.q0, idx)
    ref = -0.5 * (seen["H"] + seen["H"].T)
    assert _rel(ref, H) < 1e-8
    # the sampler runs in z (the ODE block whitened around the params) and
    # its draws come back as q = q0 + A z: z = 0 gives the params, z = 1 q0 + A 1
    seen = {}

    def sampler(logp_fn, q_init, generator, **kw):
        seen["lg"], seen["q_init"] = kw["logp_and_grad_fn"], q_init
        z = np.zeros((1, 2, q_init.shape[1]))
        z[0, 1, idx] = 1.0
        return {"samples": z, "accept_stat": np.zeros((2, 1)), "diverging": np.zeros((2, 1)),
                "step_size": np.ones(1)}

    monkeypatch.setattr(tmcmc, "nuts_sample", sampler)
    out = tmcmc.run_nuts(params_from_numpy(p, "cpu", torch.float64), batch, _tcfg(cfg),
                         torch.Generator().manual_seed(0), n_chains=1, dense_mass=True,
                         noise_sigma=SIGMA6)
    q = np.stack([out[n] for n in post.sample_names], -1)
    q0 = post.q0.numpy()[idx]
    np.testing.assert_array_equal(q[0], q0)
    np.testing.assert_allclose(q[1], q0 + A.sum(1), rtol=1e-12)
    assert np.abs(seen["q_init"][0, idx]).max() < 0.1  # the start: the params, jittered in z
    z0 = post.q0.clone()
    z0[idx] = 0.0
    np.testing.assert_allclose(seen["lg"](z0[None])[0].numpy(), post.logp(post.q0[None]).numpy(),
                               rtol=1e-12)


def _reject_cases():
    fast = FAST
    ctx = jhyb.HybridConfig(**{**FAST.__dict__, "context_points": 2, "context_dim": 3})
    return [
        ("unknown engine", fast, {}, dict(engine="gpu"), "unknown NUTS engine"),
        ("fused nn", fast, {}, dict(engine="fused", include_nn="last"), "ODE parameters only"),
        ("fused dense", fast, {}, dict(engine="fused", dense_mass=True), "dense_mass requires"),
        ("fused dopri5", jhyb.HybridConfig(**{**FAST.__dict__, "solver": "dopri5"}), {},
         dict(engine="fused"), "requires solver='rk4'"),
        ("fused tanh", jhyb.HybridConfig(**{**FAST.__dict__, "activation": "tanh"}), {},
         dict(engine="fused"), "relu. only"),
        ("fused no nn", jhyb.HybridConfig(**{**FAST.__dict__, "use_nn": False}), {},
         dict(engine="fused"), "use_nn=True and use_mech=True"),
        ("fused norm", fast, {"norm": True}, dict(engine="fused"), "'norm' physical-core"),
        ("fused context", ctx, {}, dict(engine="fused"), "context-conditioned"),
        ("fused controls", fast, {"extra": ("insulin",)}, dict(engine="fused"),
         "meal/tVNS controls only"),
    ]


@pytest.mark.parametrize("case", _reject_cases(), ids=[c[0] for c in _reject_cases()])
def test_what_the_jax_package_rejects_the_port_rejects(case, monkeypatch):
    name, cfg, opts, kw, match = case
    p = _params(cfg)
    if opts.get("norm"):
        p["norm"] = {"mean": np.zeros(6, np.float32), "std": np.ones(6, np.float32)}
    batch = _batch(extra=opts.get("extra", ()))
    monkeypatch.setattr(jmcmc, "nuts_sample", lambda *a, **k: pytest.fail("JAX sampled"))
    with pytest.raises(ValueError, match=match):
        jmcmc.run_nuts(p, batch, cfg, n_chains=1, num_samples=1, num_warmup=1, **kw)
    with pytest.raises(ValueError, match=match):
        tmcmc.run_nuts(params_from_numpy(p, "cpu"), batch, _tcfg(cfg), n_chains=1,
                       num_samples=1, num_warmup=1, **kw)


def test_chain_sharding_names_its_roadmap_item():
    """Chain sharding (ROADMAP Queue A 11) is ported: on a world of one the
    sharded samplers equal the unsharded ones draw for draw (worlds of 2:
    tests/test_torch_parallel_ensemble_nuts.py)."""
    from hybrid_ode_torch.parallel import distributed
    from hybrid_ode_torch.parallel.mesh import make_mesh

    p, batch = _params(), _batch()
    mesh = make_mesh(device="cpu")
    try:
        kw = dict(num_samples=2, num_warmup=12, max_depth=3)
        for sharded in (False, True):
            extra = {"mesh": mesh} if sharded else {}
            out = tmcmc.nuts_sample(lambda q: -0.5 * (q ** 2).sum(-1), torch.zeros(2, 2),
                                    torch.Generator().manual_seed(0), **kw, **extra)
            res = tmcmc.run_nuts(params_from_numpy(p, "cpu"), batch, _tcfg(FAST),
                                 torch.Generator().manual_seed(1), n_chains=2, **kw, **extra)
            if sharded:
                for a, b in ((ref_out, out), (ref_res, res)):
                    assert sorted(a) == sorted(b)
                    for k in a:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            ref_out, ref_res = out, res
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# diagnostics, persistence, CLI
# ---------------------------------------------------------------------------

def test_diagnostics_match_jax():
    rng = np.random.default_rng(0)
    iid = rng.standard_normal((4, 300))
    ar = np.cumsum(rng.standard_normal((4, 300)), axis=1) / 10
    heavy = rng.standard_t(2, size=(3, 201))
    for x in (iid, ar, heavy, iid[0], np.full((2, 10), 3.0)):
        for f in ("rhat", "split_rhat", "ess_bulk", "ess_tail", "compute_ess"):
            a, b = getattr(jmcmc, f)(x), getattr(tmcmc, f)(x)
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12 * max(abs(a), 1.0), f
    samples = {"a": rng.normal(size=100), "w": rng.normal(size=(100, 3)), "_diverging": np.zeros(100)}
    ref, got = jmcmc.posterior_summary(samples), tmcmc.posterior_summary(samples)
    assert sorted(ref) == sorted(got) == ["a", "w"]
    for name in ref:
        for k in ref[name]:
            np.testing.assert_allclose(got[name][k], ref[name][k], rtol=1e-12, atol=0)
    assert tmcmc.compute_ess(ar[0]) < tmcmc.compute_ess(iid[0])


@pytest.mark.parametrize("writer", ["h5py", "npz"])
def test_mcmc_results_cross_read_both_ways(writer, tmp_path, monkeypatch, caplog):
    """The NetCDF4 file through h5py and, where h5py cannot be imported, npz
    plus json: each package reads the other's, bitwise."""
    import logging

    if writer == "npz":
        monkeypatch.setitem(sys.modules, "h5py", None)
    rng = np.random.default_rng(1)
    samples = {"ode_a_GI": rng.normal(size=12).astype(np.float32),
               "nn_w2": rng.normal(size=(12, 4, 6)).astype(np.float32),
               "_accept_stat": rng.uniform(size=(3, 4)).astype(np.float32),
               "_diverging": np.zeros((3, 4), bool)}
    meta = {"engine": "fused", "chains": 4}
    with caplog.at_level(logging.INFO, logger="hybrid_ode_torch.mcmc"):
        tmcmc.save_mcmc_results(samples, str(tmp_path / "t"), meta)
    assert (writer == "h5py") == any("h5py NetCDF" in r.getMessage() for r in caplog.records)
    jmcmc.save_mcmc_results(samples, str(tmp_path / "j"), meta)
    for reader, path in ((jmcmc, "t"), (tmcmc, "j"), (tmcmc, "t")):
        got, got_meta = reader.load_mcmc_results(str(tmp_path / path))
        assert sorted(got) == sorted(samples) and got_meta == meta
        for k, v in samples.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (path, k)
    suffix = ".nc" if writer == "h5py" else ".npz"
    assert (tmp_path / f"t{suffix}").exists() and (tmp_path / f"j{suffix}").exists()


def _tiny_cfg():
    return {"data": {"path": DATA, "sequence_length": 13, "stride": 12},
            "model": {"nn_hidden": 8, "nn_layers": 2, "solver": "rk4", "substeps": 2},
            "training": {"epochs": 1, "batch_size": 8, "learning_rate": 3e-3,
                         "lambda1": 0.0, "lambda2": 0.01, "gradient_clip": 5.0,
                         "early_stopping_patience": 10},
            "ablation": {"no_nn": False, "no_bayes": False, "no_physics": True},
            "logging": {"tensorboard": False, "save_interval": 1}, "seed": 0}


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_cli_mcmc_writes_what_the_jax_package_reads(engine, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tcli.main(["--mcmc", "--mcmc-engine", engine, "--mcmc-chains", "2", "--mcmc-warmup", "2",
               "--mcmc-samples", "3", "--experiment-name", engine, "--device", "cpu"],
              config=_tiny_cfg())
    d = tmp_path / "checkpoints" / engine
    npz = np.load(d / "mcmc_samples.npz")
    got, _ = jmcmc.load_mcmc_results(str(d / "mcmc_results"))
    assert sorted(got) == sorted(npz.files)
    assert npz["ode_V_max"].shape == (6,) and npz["_accept_stat"].shape == (3, 2)
    for k in npz.files:
        assert np.array_equal(got[k], npz[k]), k


def test_the_inference_path_imports_neither_jax_nor_the_jax_package():
    """The import graph of the slice's modules, in a fresh interpreter."""
    code = ("import sys, hybrid_ode_torch.inference, hybrid_ode_torch.models.bayes, "
            "hybrid_ode_torch.evals.evaluate, hybrid_ode_torch.train.cli; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hybrid_ode_tpu', 'pandas')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_fused_engine_on_the_card_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused kernels have no CPU mode)")
    p, batch = _params(), _batch()
    sigma = SIGMA6.astype(np.float32)
    Q = None
    out = []
    for dev in ("cpu", "cuda"):
        post = tmcmc.posterior(params_from_numpy(p, dev), batch, _tcfg(FAST), "fused", sigma)
        if Q is None:
            Q = post.q0.cpu()[None] * torch.linspace(0.9, 1.1, 64)[:, None]
        out.append([x.cpu() for x in post.logp_and_grad(Q.to(dev))])
    for a, b in zip(*out):
        assert _logp_limit(a.numpy(), b.numpy()) < 1e-5
