"""Port parity: the second-derivation fused RK4 adjoint and `mlp_dtype='bf16'`
(`hybrid_ode_torch/ops/fused_rk4.py`).

On the CPU `fused_rk4_hybrid(..., bwd_impl='recompute' | 'chained')` runs
`_bwd_vjp_plain`, whose transposes come from torch autograd substep by
substep. Its gradients are held against `jax.grad` through the JAX package's
Pallas `_bwd_kernel` in interpret mode with the same `bwd_impl`, and against
the port's own 'hand' adjoint, both with the JAX suite's `_rel_err < 1e-5`
(tests/test_pallas_kernel.py::test_hand_bwd_matches_legacy_vjp_impls). The
probes' defined outputs are held to 'chained', their omitted ones to zero.

bf16: the JAX CPU backend runs the bf16 products of the interpret-mode
kernels, so the port is compared with them directly. Tolerance 1e-4 of the
largest value (`_rel_err`). Both sides round the same operands to bf16 and
differ only in the order of their f32 sums; at this size (B=11, T=5, H=16)
no operand lands on the other side of a rounding edge and the two agree to
3.4e-7 (12 cases: 4 context modes x 3 seeds), as in f32. One operand that
did would move by 2^-8 = 4e-3 of its own size, which 1e-4 of the largest
gradient leaves room for; bf16 itself moves these gradients by 5e-3 to 0.26
from their f32 values, so the tolerance still tells the two apart. That
holds for the forward and for every adjoint against the JAX hand kernel,
whose rounding points the port copies. The JAX `_bwd_kernel` rounds its
transposes elsewhere (see test_bf16_vjp_matches_its_own_jax_kernel), so the
port's 'recompute' and 'chained' are held to it at 5e-3 only. At full width
on the card, where edges are hit, chip_smoke.py states its own.

The CUDA kernel is compared with the plain version by the `cuda`-marked test,
which skips without a card, and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.ops import pallas_rk4 as jfused
from hybrid_ode_torch.ops import fused_rk4 as tfused
from hybrid_ode_torch.utils.convert import params_from_numpy
from test_torch_fused_rk4_bwd import _case, _idx, _rel_err

torch.set_num_threads(2)

BF16_TOL = 1e-4
BF16_VJP_TOL = 5e-3
PROBES = ("probe_y", "probe_yw", "probe_y_mlp", "probe_y_mech", "probe_fwd1", "probe_fwd2")


def _torch_grads(case, context, n_layers, **kw):
    """Gradients of sum(pred^2) through the port; {name: numpy}, pred."""
    p, y0, ts, meal, tvns, ctx, _ = case
    ode, nn = params_from_numpy(p["ode"], "cpu"), params_from_numpy(p["nn"], "cpu")
    for t in [*ode.values(), *nn.values()]:
        t.requires_grad_(True)
    ty0 = torch.tensor(y0, requires_grad=True)
    tctx = None if ctx is None else torch.tensor(ctx, requires_grad=True)
    pred = tfused.fused_rk4_hybrid(
        ty0, torch.as_tensor(ts), torch.as_tensor(meal), torch.as_tensor(tvns), ode, nn,
        substeps=2, n_layers=n_layers, context=tctx, context_param_idx=_idx(context),
        ctx_param_mode="abs" if context == "abs" else "mul", **kw)
    (pred ** 2).sum().backward()
    out = {"y0": ty0.grad, **{f"nn.{k}": v.grad for k, v in nn.items()},
           **{f"ode.{k}": ode[k].grad for k in tfused.PARAM_ORDER}}
    if tctx is not None:
        out["context"] = tctx.grad
    return {k: v.numpy() for k, v in out.items()}, pred.detach().numpy()


def _jax_grads(case, context, n_layers, **kw):
    p, y0, ts, meal, tvns, ctx, _ = case

    def loss(ode, nn, y0_, ctx_):
        pred = jfused.fused_rk4_hybrid(
            y0_, jnp.asarray(ts), jnp.asarray(meal), jnp.asarray(tvns), ode, nn, substeps=2,
            n_layers=n_layers, interpret=True, context=ctx_, context_param_idx=_idx(context),
            ctx_param_mode="abs" if context == "abs" else "mul", **kw)
        return jnp.sum(pred ** 2), pred

    argnums = (0, 1, 2, 3) if ctx is not None else (0, 1, 2)
    jctx = None if ctx is None else jnp.asarray(ctx)
    g, pred = jax.grad(loss, argnums=argnums, has_aux=True)(p["ode"], p["nn"], jnp.asarray(y0), jctx)
    out = {"y0": g[2], **{f"nn.{k}": v for k, v in g[1].items()},
           **{f"ode.{k}": g[0][k] for k in tfused.PARAM_ORDER}}
    if ctx is not None:
        out["context"] = g[3]
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(pred)


def _assert_close(ref, got, tol):
    assert set(ref) == set(got)
    for k in ref:
        assert _rel_err(ref[k], got[k]) < tol, k


@pytest.mark.parametrize("bwd_impl", ["recompute", "chained"])
@pytest.mark.parametrize("context,n_layers", [("none", 4), ("features", 4), ("mul", 4),
                                              ("abs", 4), ("features", 2)])
def test_vjp_gradients_match_jax_kernel(context, n_layers, bwd_impl):
    case = _case(context, n_layers)
    jg, _ = _jax_grads(case, context, n_layers, bwd_impl=bwd_impl)
    tg, _ = _torch_grads(case, context, n_layers, bwd_impl=bwd_impl)
    _assert_close(jg, tg, 1e-5)


@pytest.mark.parametrize("mlp_dtype,tol", [("f32", 1e-5), ("bf16", 1e-5)])
@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_hand_matches_recompute_and_chained(context, mlp_dtype, tol):
    """Two derivations of one adjoint; with bf16 both round the same operands,
    and on the CPU their sums run in the same order, so 1e-5 holds there too."""
    case = _case(context, 4, seed=1)
    hand, pred = _torch_grads(case, context, 4, mlp_dtype=mlp_dtype)
    for impl in ("recompute", "chained"):
        got, pred_i = _torch_grads(case, context, 4, bwd_impl=impl, mlp_dtype=mlp_dtype)
        np.testing.assert_array_equal(pred, pred_i)
        _assert_close(hand, got, tol)


def _packed(context, n_layers=2, **kw):
    p, y0, ts, meal, tvns, ctx, _ = _case(context, n_layers, **kw)
    packed = tfused.pack(*(torch.as_tensor(x) for x in (y0, ts, meal, tvns)),
                         params_from_numpy(p["ode"], "cpu"), params_from_numpy(p["nn"], "cpu"),
                         n_layers=n_layers, context=None if ctx is None else torch.as_tensor(ctx))
    mode = "abs" if context == "abs" else "mul"
    traj = tfused._fwd_plain(*packed, 2, _idx(context), mode)
    gbar = torch.as_tensor(np.random.default_rng(5).normal(size=tuple(traj.shape)).astype(np.float32))
    return (traj, gbar, *packed[1:], 2, _idx(context), mode)


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("context", ["features", "mul"])
def test_probe_outputs(context, probe):
    """A probe's defined outputs equal 'chained''s; what it leaves out is 0."""
    args = _packed(context)
    ybar0_c, dflat_c, dp_c, dctx_c = tfused.fused_rk4_bwd_vjp(*args, "f32", "chained")
    ybar0, dflat, dp, dctx = tfused.fused_rk4_bwd_vjp(*args, "f32", probe)
    assert dp.shape == dp_c.shape and float(dp.abs().max()) == 0.0
    assert dctx.shape == dctx_c.shape and float(dctx.abs().max()) == 0.0
    assert torch.isfinite(ybar0).all() and ybar0.shape == ybar0_c.shape
    if probe == "probe_yw":
        assert _rel_err(dflat_c.numpy(), dflat.numpy()) < 1e-6
    else:
        assert dflat.shape == dflat_c.shape and float(dflat.abs().max()) == 0.0
    if probe in ("probe_y", "probe_yw"):
        assert _rel_err(ybar0_c.numpy(), ybar0.numpy()) < 1e-6
    elif probe.startswith("probe_fwd"):  # the cotangents injected at the grid points, summed
        assert _rel_err(args[1].sum(0).t().numpy(), ybar0.numpy()) < 1e-6
    else:  # one part of the field only: another function of the same inputs
        assert not np.array_equal(ybar0_c.numpy(), ybar0.numpy())


def test_recompute_returns_the_summed_parameter_row():
    args = _packed("mul")
    _, _, dp_r, _ = tfused.fused_rk4_bwd_vjp(*args, "f32", "recompute")
    _, _, dp_c, _ = tfused.fused_rk4_bwd_vjp(*args, "f32", "chained")
    assert dp_r.shape == (32,) and dp_c.shape == (tfused.N_PARAMS, args[0].shape[2])
    assert _rel_err(dp_c.sum(1).numpy(), dp_r[:tfused.N_PARAMS].numpy()) < 1e-5
    assert float(dp_r[tfused.N_PARAMS:].abs().max()) == 0.0


@pytest.mark.parametrize("context", ["features", "mul"])
def test_bf16_matches_jax_kernels(context):
    case = _case(context, 4)
    g32, _ = _torch_grads(case, context, 4)
    jg, jpred = _jax_grads(case, context, 4, mlp_dtype="bf16", bwd_impl="hand")
    for impl in ("hand", "recompute"):
        tg, tpred = _torch_grads(case, context, 4, mlp_dtype="bf16", bwd_impl=impl)
        assert _rel_err(jpred, tpred) < BF16_TOL
        _assert_close(jg, tg, BF16_TOL)
    # ... and bf16 is a different function from f32, not f32 under another name
    assert max(_rel_err(g32[k], tg[k]) for k in tg) > 1e-3


@pytest.mark.parametrize("bwd_impl", ["recompute", "chained"])
@pytest.mark.parametrize("context", ["features", "mul"])
def test_bf16_vjp_matches_its_own_jax_kernel(context, bwd_impl):
    """The port's second-derivation adjoint against the JAX `_bwd_kernel` of
    the same `bwd_impl`. The two round at different points: the JAX kernel
    takes its bf16 transposes from `jax.vjp` through the field's `astype`
    casts (pallas_rk4.py:724-727), which rounds a transposed product's result
    to bf16, while the port rounds `gz` before each product and keeps the
    result in f32, as the hand kernel does (pallas_rk4.py:475-487, :533-547)
    and as test_bf16_matches_jax_kernels holds it to 1e-4. So the forward
    agrees to 1e-4 and the gradients only to BF16_VJP_TOL = 5e-3 of the
    largest value (observed at most 1.75e-3, the context leaf), and each leaf
    that bf16 moves by more than that is nearer to the JAX kernel than to its
    own f32 value."""
    case = _case(context, 4)
    g32, _ = _torch_grads(case, context, 4, bwd_impl=bwd_impl)
    jg, jpred = _jax_grads(case, context, 4, mlp_dtype="bf16", bwd_impl=bwd_impl)
    tg, tpred = _torch_grads(case, context, 4, mlp_dtype="bf16", bwd_impl=bwd_impl)
    assert _rel_err(jpred, tpred) < BF16_TOL
    _assert_close(jg, tg, BF16_VJP_TOL)
    moved = [k for k in jg if _rel_err(g32[k], tg[k]) > BF16_VJP_TOL]
    assert len(moved) >= 5  # the hidden layers' weights and biases; not e.g. the last bias
    for k in moved:
        assert _rel_err(jg[k], tg[k]) < _rel_err(g32[k], tg[k]), k


def test_bf16_rounds_the_operands_of_every_product():
    """The plain forward against a numpy emulation that rounds where the JAX
    field does (pallas_rk4.py:196-208): features, weights and every hidden
    activation, f32 accumulation, biases and ReLU in f32."""
    rng = np.random.default_rng(2)

    def r(x):
        return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()

    B, H = 5, 8
    nn = {"w0": rng.normal(size=(9, H)), "b0": rng.normal(size=H), "w1": rng.normal(size=(H, H)),
          "b1": rng.normal(size=H), "w2": 0.1 * rng.normal(size=(H, 6)), "b2": rng.normal(size=6)}
    nn = {k: v.astype(np.float32) for k, v in nn.items()}
    pw = tfused._pack_weights(params_from_numpy(nn, "cpu"), 2)
    t, m, v = (torch.as_tensor(rng.normal(size=B).astype(np.float32)) for _ in range(3))
    Y = torch.as_tensor(rng.normal(size=(6, B)).astype(np.float32))
    fixed = tfused._fixed_features(None, (), pw.in_pad, B, Y)
    P = tfused._effective_params(torch.ones(32), None, (), "mul")
    k, X, acts = tfused._stage_eval(t, Y, m, v, P, fixed, pw, "bf16", "mlp")
    h = r(X.numpy()[:9])
    for i in range(2):
        h = r(np.maximum(r(nn[f"w{i}"]).T @ h + nn[f"b{i}"][:, None], 0.0))
    ref = r(nn["w2"]).T @ h + nn["b2"][:, None]
    np.testing.assert_allclose(k.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert acts[0].dtype == torch.float32  # saved activations stay unrounded f32


def test_vjp_wrapper_rejects_unknown_impl_and_cpu_tensors_for_the_kernel():
    args = _packed("none")
    with pytest.raises(ValueError, match="bwd_impl"):
        tfused.fused_rk4_bwd_vjp(*args, "f32", "hand")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfused._bwd_vjp_cuda(*args)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfused.fused_rk4_bwd_vjp(args[0].to("meta"), *args[1:])
    before = tfused.fused_rk4_bwd_vjp_launches
    tfused.fused_rk4_bwd_vjp(*args)
    assert tfused.fused_rk4_bwd_vjp_launches == before  # the plain version is no launch


@pytest.mark.cuda
@pytest.mark.parametrize("bwd_impl", ["recompute", "chained"])
@pytest.mark.parametrize("context", ["none", "features", "mul", "abs"])
def test_cuda_vjp_kernel_matches_plain_version(context, bwd_impl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _packed(context, 4, B=300, T=9, H=32)
    ref = tfused.fused_rk4_bwd_vjp(*args, "f32", bwd_impl)
    cu = lambda x: x.cuda() if torch.is_tensor(x) else x  # noqa: E731
    pw = args[6]
    pw_cu = tfused._unflatten(pw.flat.cuda(), pw.in_pad, pw.hidden, pw.n_layers)
    out = tfused.fused_rk4_bwd_vjp(*(pw_cu if a is pw else cu(a) for a in args), "f32", bwd_impl)
    torch.cuda.synchronize()
    for name, k, r in zip(("ybar0", "dflat", "dp", "dctx"), out, ref):
        if r is not None:
            assert _rel_err(r.numpy(), k.cpu().numpy()) < 1e-5, name
