"""Port parity: the fused RK4 adjoint (`hybrid_ode_torch/ops/fused_rk4.py`).

On the CPU `fused_rk4_hybrid`'s backward runs the hand adjoint's plain
PyTorch version (`_bwd_plain`). Its gradients are held against `jax.grad`
through the JAX package's `fused_rk4_hybrid(..., interpret=True)` (the Pallas
`_bwd_kernel_hand` in interpret mode) with the JAX suite's own
`_rel_err < 1e-5` (tests/test_pallas_kernel.py), and, as an independent
check, against torch autograd through `_fwd_plain` in f64. The CUDA kernel
is compared with the plain version by the `cuda`-marked test, which skips
without a card, and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.ops import pallas_rk4 as jfused
from hybrid_ode_torch.dynamics.ode_core import make_ode_params
from hybrid_ode_torch.ops import fused_rk4 as tfused
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

CTX_PARAMS = ("G_b", "I_b", "Glu_b")


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-8)


def _case(context, n_layers, seed=0, B=11, T=5, H=16):
    """JAX-initialised model + inputs for one option case, numpy from a seed."""
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
    tgt = rng.normal(size=(B, T, 6)).astype(np.float32)
    return p, y0, ts, meal, tvns, ctx, tgt


def _idx(context):
    return tuple(tfused.PARAM_ORDER.index(n) for n in CTX_PARAMS) if context in ("mul", "abs") else ()


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_fused_gradients_match_jax(context, n_layers, substeps):
    p, y0, ts, meal, tvns, ctx, tgt = _case(context, n_layers)
    mode = "abs" if context == "abs" else "mul"
    kw = dict(substeps=substeps, n_layers=n_layers, context_param_idx=_idx(context),
              ctx_param_mode=mode)

    def jloss(ode, nn, y0_, ctx_):
        pred = jfused.fused_rk4_hybrid(y0_, jnp.asarray(ts), jnp.asarray(meal),
                                       jnp.asarray(tvns), ode, nn, interpret=True,
                                       context=ctx_, **kw)
        return jnp.sum(pred * tgt)

    argnums = (0, 1, 2, 3) if ctx is not None else (0, 1, 2)
    jctx = None if ctx is None else jnp.asarray(ctx)
    jg = jax.grad(jloss, argnums=argnums)(p["ode"], p["nn"], jnp.asarray(y0), jctx)

    ode, nn = params_from_numpy(p["ode"], "cpu"), params_from_numpy(p["nn"], "cpu")
    leaves = [*ode.values(), *nn.values()]
    for t in leaves:
        t.requires_grad_(True)
    ty0 = torch.tensor(y0, requires_grad=True)
    tctx = None if ctx is None else torch.tensor(ctx, requires_grad=True)
    pred = tfused.fused_rk4_hybrid(ty0, torch.as_tensor(ts), torch.as_tensor(meal),
                                   torch.as_tensor(tvns), ode, nn, context=tctx, **kw)
    (pred * torch.as_tensor(tgt)).sum().backward()

    assert _rel_err(jg[2], ty0.grad.numpy()) < 1e-5, "y0"
    for k in p["nn"]:
        assert _rel_err(jg[1][k], nn[k].grad.numpy()) < 1e-5, k
    assert set(tfused.PARAM_ORDER) <= set(p["ode"])
    for k in tfused.PARAM_ORDER:
        assert _rel_err(jg[0][k], ode[k].grad.numpy()) < 1e-5, k
    if ctx is not None:
        assert _rel_err(jg[3], tctx.grad.numpy()) < 1e-5, "context"


@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_bwd_plain_matches_autograd_through_fwd_plain(context):
    """Independent of JAX: the hand adjoint equals autograd of the plain
    forward, in f64 (agreement to rounding)."""
    rng = np.random.default_rng(3)
    B, T, H, L, C = 5, 4, 8, 2, 3
    f64 = torch.float64

    def rnd(*shape, scale=1.0):
        return torch.tensor(scale * rng.normal(size=shape), dtype=f64)

    in_dim = 9 + (C if context == "features" else 0)
    dims = [in_dim] + [H] * L + [6]
    nn = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        nn[f"w{i}"], nn[f"b{i}"] = rnd(a, b, scale=0.3), rnd(b, scale=0.1)
    ode = {k: torch.tensor(float(v), dtype=f64) for k, v in make_ode_params(device="cpu").items()}
    y0 = torch.tensor([8.0, 100.0, 90.0, 20.0, 0.5, 1.2], dtype=f64) * (1 + 0.1 * rnd(B, 6))
    ts_t = torch.tensor(np.cumsum(rng.uniform(0.05, 0.2, (B, T)), 1).T.copy())
    meal_t, tvns_t = rnd(T, B).abs(), rnd(T, B).abs()
    idx, mode, ctx_t = _idx(context), "abs" if context == "abs" else "mul", None
    if context != "none":
        ctx_t = rnd(C, B, scale=0.2)
    if context == "abs":
        ctx_t = torch.tensor([5.0, 60.0, 80.0], dtype=f64)[:, None] * (1 + ctx_t)
    pw0 = tfused._pack_weights(nn, L)
    flat = pw0.flat.to(f64).requires_grad_(True)
    pvec = tfused._pack_params(ode).to(f64).requires_grad_(True)
    y0r = y0.clone().requires_grad_(True)
    ctx_r = None if ctx_t is None else ctx_t.clone().requires_grad_(True)
    pw = tfused._unflatten(flat, pw0.in_pad, pw0.hidden, L)
    traj = tfused._fwd_plain(y0r, ts_t, meal_t, tvns_t, ctx_r, pw, pvec, 2, idx, mode)
    gbar = rnd(*traj.shape)
    wrt = [y0r, flat, pvec] + ([ctx_r] if ctx_r is not None else [])
    ref = torch.autograd.grad((traj * gbar).sum(), wrt)
    with torch.no_grad():
        ybar0, dflat, dp, dctx = tfused._bwd_plain(traj, gbar, ts_t, meal_t, tvns_t, ctx_t,
                                                   pw, pvec, 2, idx, mode)
    assert dp.shape == (tfused.N_PARAMS, B) and dflat.shape == flat.shape
    np.testing.assert_allclose(ybar0.numpy(), ref[0].numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dflat.numpy(), ref[1].numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dp.sum(1).numpy(), ref[2][:tfused.N_PARAMS].numpy(),
                               rtol=1e-10, atol=1e-12)
    if ctx_t is not None:
        np.testing.assert_allclose(dctx.numpy(), ref[3].t().numpy(), rtol=1e-10, atol=1e-12)


def test_bwd_wrapper_rejects_cpu_tensors_for_the_kernel():
    """The kernel path never takes a CPU tensor (no quiet fallback)."""
    p, y0, ts, meal, tvns, _, _ = _case("none", 2)
    y0_k, ts_t, meal_t, tvns_t, ctx_t, pw, pvec = tfused.pack(
        *(torch.as_tensor(x) for x in (y0, ts, meal, tvns)), params_from_numpy(p["ode"], "cpu"),
        params_from_numpy(p["nn"], "cpu"), n_layers=2)
    traj = tfused._fwd_plain(y0_k, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfused._bwd_cuda(traj, traj, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfused.fused_rk4_bwd(traj.to("meta"), traj, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_cuda_bwd_kernel_matches_plain_version(context):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p, y0, ts, meal, tvns, ctx, _ = _case(context, 4, B=300, T=9, H=32)
    mode = "abs" if context == "abs" else "mul"
    gbar = np.random.default_rng(1).normal(size=(9, 6, 300)).astype(np.float32)
    outs = []
    for dev in ("cpu", "cuda"):
        packed = tfused.pack(*(torch.as_tensor(x, device=dev) for x in (y0, ts, meal, tvns)),
                             params_from_numpy(p["ode"], dev), params_from_numpy(p["nn"], dev),
                             n_layers=4, context=None if ctx is None else torch.as_tensor(ctx, device=dev))
        traj = tfused.fused_rk4_fwd(*packed, 2, _idx(context), mode)
        outs.append(tfused.fused_rk4_bwd(traj, torch.as_tensor(gbar, device=dev), *packed[1:], 2,
                                         _idx(context), mode))
    torch.cuda.synchronize()
    for name, k, ref in zip(("ybar0", "dflat", "dp", "dctx"), outs[1], outs[0]):
        if ref is not None:
            assert _rel_err(ref.numpy(), k.cpu().numpy()) < 1e-5, name
