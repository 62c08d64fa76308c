"""Port parity: dynamics, controls and fixed-grid solvers against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; parameters
are carried across with `params_from_numpy`. Tolerances: float32 on both
sides, same formulas, so 1e-5 relative for single field evaluations and
2e-4 for whole trajectories (the JAX suite's fused-vs-XLA tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.dynamics import controls as jctrl
from hybrid_ode_tpu.dynamics import ode_core as jode
from hybrid_ode_tpu.dynamics import residual as jres
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_torch.dynamics import controls as tctrl
from hybrid_ode_torch.dynamics import ode_core as tode
from hybrid_ode_torch.dynamics import residual as tres
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.solvers.api import odeint as t_odeint
from hybrid_ode_torch.utils.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

Y_SCALE = np.array([8.0, 100.0, 90.0, 20.0, 0.5, 1.2], np.float32)


def _states(rng, n):
    return (Y_SCALE * (1 + 0.2 * rng.normal(size=(n, 6)))).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("extra", ["none", "k_ex", "S_I", "GD"])
def test_mechanistic_field_matches_jax(extra):
    rng = np.random.default_rng(0)
    y = _states(rng, 16)
    p = {k: np.float32(v * (1 + 0.1 * rng.normal())) for k, v in tode.DEFAULT_ODE_PARAMS.items()}
    inputs = {"meal": rng.uniform(0, 2, 16).astype(np.float32)}
    if extra == "k_ex":
        p["k_ex"] = np.float32(0.7)
        inputs["I_ex"] = rng.uniform(0, 1, 16).astype(np.float32)
    if extra == "S_I":
        p["S_I"] = np.float32(-0.02)  # |S_I| is what enters
    if extra == "GD":
        inputs["GD"] = np.where(rng.uniform(size=16) > 0.5, rng.uniform(0, 900, 16), 0.0
                                ).astype(np.float32)
    ref = jode.mechanistic_field(0.0, jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()},
                                 {k: jnp.asarray(v) for k, v in inputs.items()})
    out = tode.mechanistic_field(0.0, _t(y), params_from_numpy(p, "cpu"),
                                 {k: _t(v) for k, v in inputs.items()})
    _close(out, ref)


def test_safe_pow_gradient_finite_at_zero():
    x = torch.tensor([0.0, 2.0], requires_grad=True)
    tode._safe_pow(x, torch.tensor(2.0)).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 4.0])


def test_ode_params_and_steady_state_match_jax():
    over = {"G_b": 6.0, "k_L": 0.03}
    jp = _np(jode.make_ode_params(over))
    tp = params_to_numpy(tode.make_ode_params(over, device="cpu"))
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(jp[k], tp[k])
    np.testing.assert_array_equal(np.asarray(jode.steady_state(jp)),
                                  tode.steady_state(params_from_numpy(jp, "cpu")).numpy())
    assert tode.BAYES_ODE_PARAM_NAMES == jode.BAYES_ODE_PARAM_NAMES


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(1)
    xp = np.array([0.0, 0.5, 0.5, 1.0, 2.0], np.float32)  # one degenerate interval
    fp = rng.normal(size=5).astype(np.float32)
    xs = np.array([-1.0, 0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0], np.float32)
    ref = [float(jnp.interp(x, xp, fp)) for x in xs]
    out = tctrl.interp(_t(xs), _t(np.broadcast_to(xp, (9, 5))), _t(np.broadcast_to(fp, (9, 5))))
    _close(out, ref, rtol=1e-6, atol=1e-7)
    jc = jctrl.Controls(ts=jnp.asarray(xp), signals={"meal": jnp.asarray(fp),
                                                     "GD": jnp.asarray(3.0)})
    tc = tctrl.Controls(ts=_t(xp), signals={"meal": _t(fp), "GD": torch.tensor(3.0)})
    for x in (0.3, 1.7):
        r, o = jctrl.eval_controls(jc, x), tctrl.eval_controls(tc, torch.tensor(x))
        assert r.keys() == o.keys()
        for k in r:
            _close(o[k], r[k])


def test_residual_apply_and_l2_match_jax():
    rng = np.random.default_rng(2)
    nn = _np(jres.init_mlp_params(jax.random.PRNGKey(0), input_dim=13, hidden_dim=16,
                                  n_layers=3))
    nn["w3"] = (0.1 * rng.normal(size=nn["w3"].shape)).astype(np.float32)
    y = _states(rng, 8)
    t = rng.uniform(0, 5, 8).astype(np.float32)
    tv = rng.uniform(0, 1, 8).astype(np.float32)
    extra = rng.normal(size=(8, 4)).astype(np.float32)
    for act in ("relu", "tanh", "elu", "leaky_relu"):
        ref = jres.residual_apply(nn, t, y, y[:, 3], tv, act, extra=extra)
        out = tres.residual_apply(params_from_numpy(nn, "cpu"), _t(t), _t(y), _t(y[:, 3]),
                                  _t(tv), act, extra=_t(extra))
        _close(out, ref)
    _close(tres.mlp_l2(params_from_numpy(nn, "cpu"), 0.01), jres.mlp_l2(nn, 0.01))


def test_init_mlp_params_structure():
    g = torch.Generator().manual_seed(0)
    tp = tres.init_mlp_params(g, input_dim=9, hidden_dim=32, n_layers=3, device="cpu")
    jp = jres.init_mlp_params(jax.random.PRNGKey(0), input_dim=9, hidden_dim=32, n_layers=3)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert float(tp["w3"].abs().max()) == 0.0
    # xavier-normal std with gain 0.1
    assert abs(float(tp["w1"].std()) - 0.1 * np.sqrt(2 / 64)) < 0.005


@pytest.mark.parametrize("name", ["make_ode_params", "init_mlp_params", "init_hybrid_params"])
def test_parameter_constructors_default_to_the_card(name):
    """Like every entry point, the constructors place their tensors on CUDA
    unless the caller passes device='cpu'; without CUDA the default raises
    and names the way out."""
    build = {"make_ode_params": lambda **kw: {"ode": tode.make_ode_params(**kw)},
             "init_mlp_params": lambda **kw: {"nn": tres.init_mlp_params(
                 torch.Generator().manual_seed(0), input_dim=9, hidden_dim=8, n_layers=2, **kw)},
             "init_hybrid_params": lambda **kw: thyb.init_hybrid_params(
                 torch.Generator().manual_seed(0), thyb.HybridConfig(nn_hidden=8, nn_layers=2),
                 **kw)}[name]
    leaves = lambda tree: [v for d in tree.values() for v in d.values()]  # noqa: E731
    if torch.cuda.is_available():
        assert all(v.is_cuda for v in leaves(build()))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    on_cpu = leaves(build(device="cpu"))
    assert on_cpu and all(v.device.type == "cpu" for v in on_cpu)


def _model(context, exog, norm, rng, H=16):
    cfg = jhyb.HybridConfig(nn_hidden=H, nn_layers=2, solver="rk4", substeps=2,
                            context_points=3 if context != "none" else 0, context_dim=4,
                            context_mode="params" if context == "params" else "features",
                            exog_insulin=exog)
    ns = (Y_SCALE, 0.5 * Y_SCALE) if norm else None
    p = _np(jhyb.init_hybrid_params(jax.random.PRNGKey(0), cfg, norm_stats=ns))
    p["nn"][f"w{cfg.nn_layers}"] = (0.05 * rng.normal(size=p["nn"]["w2"].shape)).astype(np.float32)
    if "k_ex" in p["ode"]:
        p["ode"]["k_ex"] = np.float32(0.8)
    return cfg, p


@pytest.mark.parametrize("exog", ["nn", "mech", "both", "mech_blind"])
@pytest.mark.parametrize("context", ["none", "features", "params"])
@pytest.mark.parametrize("norm", [False, True])
def test_hybrid_field_matches_jax(norm, context, exog):
    rng = np.random.default_rng(3)
    cfg, p = _model(context, exog, norm, rng)
    B, T = 6, 5
    y = _states(rng, B) / (Y_SCALE if norm else 1.0)
    ts = np.cumsum(rng.uniform(0.05, 0.3, (B, T)), 1).astype(np.float32)
    t = (ts[:, 1] + 0.03).astype(np.float32)
    sig = {"meal": rng.uniform(0, 2, (B, T)).astype(np.float32),
           "tVNS": rng.uniform(0, 1, (B, T)).astype(np.float32)}
    if context != "none":
        C = 4 if context == "features" else 3
        sig["context"] = (0.2 * rng.normal(size=(B, C))).astype(np.float32)
    jc = jctrl.Controls(ts=jnp.asarray(ts), signals={k: jnp.asarray(v) for k, v in sig.items()})
    axes = jctrl.Controls(ts=0, signals={k: 0 for k in sig})
    ref = jax.vmap(lambda tt, yy, cc: jhyb.hybrid_field(tt, yy, p, cc, cfg),
                   in_axes=(0, 0, axes))(jnp.asarray(t), jnp.asarray(y), jc)
    tcfg = thyb.HybridConfig(**dataclasses.asdict(cfg))
    tc = tctrl.Controls(ts=_t(ts), signals={k: _t(v) for k, v in sig.items()})
    out = thyb.hybrid_field(_t(t), _t(y), params_from_numpy(p, "cpu"), tc, tcfg)
    _close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("solver", ["rk4", "euler"])
def test_batched_forward_odeint_matches_jax(solver):
    rng = np.random.default_rng(4)
    cfg, p = _model("features", "nn", False, rng)
    cfg = dataclasses.replace(cfg, solver=solver)
    B, T = 5, 6
    y0 = _states(rng, B)
    ts = np.cumsum(rng.uniform(0.05, 0.3, (B, T)), 1).astype(np.float32)
    sig = {"meal": rng.uniform(0, 2, (B, T)).astype(np.float32),
           "tVNS": rng.uniform(0, 1, (B, T)).astype(np.float32),
           "context": (0.2 * rng.normal(size=(B, 4))).astype(np.float32)}
    ref = jhyb.batched_forward(p, jnp.asarray(y0), jnp.asarray(ts), jctrl.Controls(
        ts=jnp.asarray(ts), signals={k: jnp.asarray(v) for k, v in sig.items()}), cfg)
    tcfg = thyb.HybridConfig(**dataclasses.asdict(cfg))
    out = thyb.batched_forward(params_from_numpy(p, "cpu"), _t(y0), _t(ts),
                               tctrl.Controls(ts=_t(ts), signals={k: _t(v) for k, v in sig.items()}),
                               tcfg)
    assert out.shape == (B, T, 6)
    _close(out, ref, rtol=2e-4, atol=2e-4)
    # a single trajectory through `forward` is row 0 of the batch
    one = thyb.forward(params_from_numpy(p, "cpu"), _t(y0[0]), _t(ts[0]), tctrl.Controls(
        ts=_t(ts[0]), signals={k: _t(v[0]) for k, v in sig.items()}), tcfg)
    _close(one, out[0], rtol=1e-6, atol=1e-6)


def test_odeint_rk4_exponential_decay_and_unported_solvers():
    ts = torch.linspace(0.0, 1.0, 5)
    ys = t_odeint(lambda t, y, a: -a * y, torch.ones(2, 1), ts, 2.0, solver="rk4", substeps=4)
    np.testing.assert_allclose(ys[0, :, 0].numpy(), np.exp(-2.0 * ts.numpy()), rtol=1e-5)
    ys = t_odeint(lambda t, y, a: -a * y, torch.ones(2, 1), ts, 2.0, solver="dopri5")
    np.testing.assert_allclose(ys[0, :, 0].numpy(), np.exp(-2.0 * ts.numpy()), rtol=1e-5)
    for name in ("radau", "bdf", "bdf2"):  # ported (ROADMAP Queue A 14)
        ys = t_odeint(lambda t, y, a: -a * y, torch.ones(2, 1, dtype=torch.float64),
                      ts.double(), 2.0, solver=name, mode="while", rtol=1e-6, atol=1e-9,
                      max_steps_per_interval=128)
        np.testing.assert_allclose(ys[0, :, 0].numpy(), np.exp(-2.0 * ts.numpy()), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="unknown solver"):
        t_odeint(lambda t, y, a: -y, torch.ones(1), ts, solver="nope")


@pytest.mark.parametrize("context,exog", [("none", "nn"), ("features", "mech_blind"),
                                          ("params", "mech")])
def test_init_hybrid_params_structure_and_flat_views_match_jax(context, exog):
    cfg, jp = _model(context, exog, True, np.random.default_rng(5))
    tcfg = thyb.HybridConfig(**dataclasses.asdict(cfg))
    tp = thyb.init_hybrid_params(torch.Generator().manual_seed(0), tcfg,
                                 norm_stats=(Y_SCALE, 0.5 * Y_SCALE), device="cpu")
    shapes = lambda tree: {g: {k: tuple(np.shape(v)) for k, v in d.items()}  # noqa: E731
                           for g, d in tree.items()}
    assert shapes(params_to_numpy(tp)) == shapes(jp)
    for k in ("k_ex", "S_I"):
        if k in jp["ode"]:
            assert float(tp["ode"][k]) == pytest.approx(float(
                jhyb.init_hybrid_params(jax.random.PRNGKey(0), cfg)["ode"][k]))
    np.testing.assert_array_equal(tp["norm"]["std"].numpy(), jp["norm"]["std"])
    flat = thyb.params_to_flat(params_from_numpy(jp, "cpu"))
    assert sorted(flat) == sorted(jhyb.params_to_flat(jp))
    back = thyb.flat_to_params({"ode_G_b": torch.tensor(7.0)}, params_from_numpy(jp, "cpu"))
    assert float(back["ode"]["G_b"]) == 7.0 and sorted(back) == sorted(jp)
    with pytest.raises(KeyError):
        thyb.flat_to_params({"enc_w0": torch.zeros(1)}, tp)


def test_odeint_checkpointed_intervals_give_the_same_gradient():
    ts = torch.linspace(0.0, 1.0, 4)
    grads = []
    for ckpt in (True, False):
        k = torch.tensor(1.5, requires_grad=True)
        ys = t_odeint(lambda t, y, a: -a * y * y, torch.ones(3, 2), ts, k, solver="rk4",
                      substeps=2, checkpoint_intervals=ckpt)
        ys.sum().backward()
        grads.append(float(k.grad))
    assert grads[0] == pytest.approx(grads[1], rel=1e-6)
