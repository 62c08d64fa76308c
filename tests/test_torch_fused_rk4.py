"""Port parity: the fused RK4 forward (`hybrid_ode_torch/ops/fused_rk4.py`).

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode and against the JAX scan
path (`batched_forward`, solver='rk4'), at rtol=atol=2e-4, the JAX suite's
own fused-vs-XLA tolerance (tests/test_pallas_kernel.py). The CUDA kernel
itself is compared with the plain version by the `cuda`-marked test, which
skips without a card, and by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.dynamics.controls import Controls as JControls
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.ops import pallas_rk4 as jfused
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.ops import fused_rk4 as tfused
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
CTX_PARAMS = ("G_b", "I_b", "Glu_b")


def _case(context, n_layers, seed=0, B=11, T=5, H=16):
    """Model + inputs for one case, all numpy from a seed."""
    rng = np.random.default_rng(seed)
    cfg = jhyb.HybridConfig(nn_hidden=H, nn_layers=n_layers, solver="rk4",
                            context_points=3 if context != "none" else 0, context_dim=4,
                            context_mode="features" if context == "features" else "params",
                            context_params=CTX_PARAMS)
    p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(seed), cfg))
    last = f"w{n_layers}"
    p["nn"][last] = (0.05 * rng.normal(size=p["nn"][last].shape)).astype(np.float32)
    y0 = (np.array([8.0, 100.0, 90.0, 20.0, 0.5, 1.2], np.float32)
          * (1 + 0.1 * rng.normal(size=(B, 6)))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.05, 0.25, (B, T)), 1).astype(np.float32)
    meal = np.where(rng.uniform(size=(B, T)) > 0.6, 2.0, 0.0).astype(np.float32)
    tvns = rng.uniform(0, 1, (B, T)).astype(np.float32)
    ctx = None
    if context == "features":
        ctx = (0.3 * rng.normal(size=(B, 4))).astype(np.float32)
    elif context == "mul":
        ctx = (0.2 * rng.normal(size=(B, 3))).astype(np.float32)
    elif context == "abs":
        base = np.array([p["ode"][n] for n in CTX_PARAMS], np.float32)
        ctx = (base * (1 + 0.2 * rng.normal(size=(B, 3)))).astype(np.float32)
    return cfg, p, y0, ts, meal, tvns, ctx


def _idx(context):
    return tuple(tfused.PARAM_ORDER.index(n) for n in CTX_PARAMS) if context in ("mul", "abs") else ()


def _t(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_fused_trajectory_matches_jax(context, n_layers, substeps):
    cfg, p, y0, ts, meal, tvns, ctx = _case(context, n_layers)
    mode = "abs" if context == "abs" else "mul"
    out = tfused.fused_rk4_trajectory(
        _t(y0), _t(ts), _t(meal), _t(tvns), params_from_numpy(p["ode"], "cpu"),
        params_from_numpy(p["nn"], "cpu"), substeps=substeps, n_layers=n_layers,
        context=_t(ctx), context_param_idx=_idx(context), ctx_param_mode=mode).numpy()
    assert out.shape == (y0.shape[0], ts.shape[1], 6)
    ref = jfused.fused_rk4_trajectory(
        jnp.asarray(y0), jnp.asarray(ts), jnp.asarray(meal), jnp.asarray(tvns), p["ode"],
        p["nn"], substeps=substeps, n_layers=n_layers, interpret=True,
        context=None if ctx is None else jnp.asarray(ctx), context_param_idx=_idx(context),
        ctx_param_mode=mode)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    if context == "abs":
        return  # the scan path has no absolute-parameter mode
    sig = {"meal": meal, "tVNS": tvns}
    if ctx is not None:
        sig["context"] = ctx
    scan = jhyb.batched_forward(p, jnp.asarray(y0), jnp.asarray(ts), JControls(
        ts=jnp.asarray(ts), signals={k: jnp.asarray(v) for k, v in sig.items()}),
        dataclasses.replace(cfg, substeps=substeps))
    np.testing.assert_allclose(out, np.asarray(scan), **TOL)


def test_use_pallas_batched_forward_matches_scan_path():
    """Port's own dispatch: use_pallas (plain version on CPU) vs the port's scan."""
    cfg, p, y0, ts, meal, tvns, ctx = _case("mul", 2, seed=1)
    tcfg = thyb.HybridConfig(**dataclasses.asdict(cfg))
    params = params_from_numpy(p, "cpu")
    ctrl = Controls(ts=_t(ts), signals={"meal": _t(meal), "tVNS": _t(tvns), "context": _t(ctx)})
    before = tfused.fused_rk4_fwd_launches
    with torch.no_grad():
        fused = thyb.batched_forward(params, _t(y0), _t(ts), ctrl,
                                     dataclasses.replace(tcfg, use_pallas=True))
        scan = thyb.batched_forward(params, _t(y0), _t(ts), ctrl, tcfg)
    np.testing.assert_allclose(fused.numpy(), scan.numpy(), **TOL)
    assert tfused.fused_rk4_fwd_launches == before  # the plain version is no launch


@pytest.mark.parametrize("change,match", [
    (dict(solver="dopri5"), "solver='rk4'"),
    (dict(activation="tanh"), "relu"),
    (dict(exog_insulin="mech"), "exogenous-insulin"),
    (dict(use_nn=False), "use_nn"),
])
def test_use_pallas_guards(change, match):
    cfg, p, y0, ts, meal, tvns, _ = _case("none", 2)
    tcfg = thyb.HybridConfig(**{**dataclasses.asdict(cfg), "use_pallas": True, **change})
    with pytest.raises(ValueError, match=match):
        thyb.batched_forward(params_from_numpy(p, "cpu"), _t(y0), _t(ts), None, tcfg)


def test_use_pallas_params_mode_requires_context_and_rejects_extra_signals():
    cfg, p, y0, ts, meal, tvns, ctx = _case("mul", 2)
    tcfg = thyb.HybridConfig(**{**dataclasses.asdict(cfg), "use_pallas": True})
    params = params_from_numpy(p, "cpu")
    with pytest.raises(ValueError, match="without a 'context'"):
        thyb.batched_forward(params, _t(y0), _t(ts), None, tcfg)
    ctrl = Controls(ts=_t(ts), signals={"GD": _t(meal), "context": _t(ctx)})
    with pytest.raises(ValueError, match="meal/tVNS/context"):
        thyb.batched_forward(params, _t(y0), _t(ts), ctrl, tcfg)
    with pytest.raises(ValueError, match="'norm'"):
        thyb.batched_forward({**params, "norm": {}}, _t(y0), _t(ts), ctrl, tcfg)


def test_pack_weights_layout():
    _, p, *_ = _case("features", 2, H=14)
    pw = tfused._pack_weights(params_from_numpy(p["nn"], "cpu"), 2)
    assert (pw.in_pad, pw.hidden, pw.n_layers) == (16, 16, 2)
    assert [tuple(w.shape) for w in pw.ws] == [(16, 16), (16, 16), (16, 8)]
    assert [tuple(b.shape) for b in pw.bs] == [(16,), (16,), (8,)]
    assert all(w.data_ptr() >= pw.flat.data_ptr() for w in pw.ws)  # views into flat
    np.testing.assert_array_equal(pw.ws[0][:13, :14].numpy(), p["nn"]["w0"])
    assert float(pw.ws[0][13:].abs().sum() + pw.ws[0][:, 14:].abs().sum()) == 0.0
    np.testing.assert_array_equal(pw.ws[2][:14, :6].numpy(), p["nn"]["w2"])
    assert pw.flat.numel() % 4 == 0
    pvec = tfused._pack_params(params_from_numpy(p["ode"], "cpu"))
    assert pvec.shape == (32,) and float(pvec[17:].abs().sum()) == 0.0
    assert float(pvec[tfused.PARAM_ORDER.index("K_m")]) == pytest.approx(float(p["ode"]["K_m"]))


def test_fused_options_not_ported_or_invalid_raise():
    _, p, y0, ts, meal, tvns, _ = _case("none", 2)
    args = (_t(y0), _t(ts), _t(meal), _t(tvns), params_from_numpy(p["ode"], "cpu"),
            params_from_numpy(p["nn"], "cpu"))
    with pytest.raises(ValueError, match="mlp_dtype"):
        tfused.fused_rk4_trajectory(*args, n_layers=2, mlp_dtype="f16")
    with pytest.raises(ValueError, match="ctx_param_mode"):
        tfused.fused_rk4_trajectory(*args, n_layers=2, ctx_param_mode="add")
    with pytest.raises(ValueError, match="layers"):
        tfused.fused_rk4_trajectory(*args, n_layers=3)
    with pytest.raises(ValueError, match="bwd_impl"):
        tfused.fused_rk4_hybrid(*args, n_layers=2, bwd_impl="adjoint")
    assert tfused.BWD_IMPLS == ("hand", "recompute", "chained", "probe_y", "probe_yw",
                                "probe_y_mlp", "probe_y_mech", "probe_fwd1", "probe_fwd2")
    y0g = args[0].clone().requires_grad_(True)
    assert tfused.fused_rk4_hybrid(y0g, *args[1:], n_layers=2).grad_fn is not None
    assert tfused.fused_rk4_trajectory(y0g, *args[1:], n_layers=2).grad_fn is None


def test_cuda_launcher_rejects_cpu_tensors():
    """The kernel path never takes a CPU tensor (no quiet fallback)."""
    _, p, y0, ts, meal, tvns, _ = _case("none", 2)
    packed = tfused.pack(_t(y0), _t(ts), _t(meal), _t(tvns), params_from_numpy(p["ode"], "cpu"),
                         params_from_numpy(p["nn"], "cpu"), n_layers=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfused._fwd_cuda(*packed, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfused.fused_rk4_fwd(_t(y0).to("meta"), *packed[1:], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_cuda_kernel_matches_plain_version(context):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, p, y0, ts, meal, tvns, ctx = _case(context, 4, B=300, T=9, H=32)
    mode = "abs" if context == "abs" else "mul"
    outs = []
    for dev in ("cpu", "cuda"):
        packed = tfused.pack(*(torch.as_tensor(x, device=dev) for x in (y0, ts, meal, tvns)),
                             params_from_numpy(p["ode"], dev), params_from_numpy(p["nn"], dev),
                             n_layers=4, context=None if ctx is None else torch.as_tensor(ctx, device=dev))
        outs.append(tfused.fused_rk4_fwd(*packed, 2, _idx(context), mode).cpu().numpy())
    torch.cuda.synchronize()
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
