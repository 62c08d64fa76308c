"""Port parity: the host side of the Hopper layout of the fused RK4 kernels.

The forward kernel and the hand adjoint work on 64-sample tiles with the MLP
weights staged in shared memory (`hybrid_ode_torch/csrc/fused_rk4_wide.cuh`).
What Python adds for that is tested here on the CPU:
  * `_kernel_weights(..., transposed=True)`: the packed weights followed by
    every layer once more as (out, in) row-major; the copy round-trips to the
    packed layers (`_unflatten`) and multiplies like them;
  * `_bwd_workspace`: the buffers allocated for a launch from the sizes the
    adjoint's library reports. The sizes here come from chip_smoke.py's
    pure-Python statement of the kernel's formula, the one the library is
    held to on a card (by chip_smoke.py on every run, and by the
    `cuda`-marked test); partials must be the packed weights and biases;
  * batches of 2, tile - 1 and tile + 1 samples through `fused_rk4_hybrid`
    (on the CPU the plain versions) against the JAX kernels in interpret
    mode, gradients by the JAX suite's `_rel_err < 1e-5`, the trajectory to
    rtol = atol = 2e-4, as tests/test_torch_fused_rk4_bwd.py and
    tests/test_torch_fused_rk4.py hold them;
  * the route rule of small batches (`_cluster_route`, `_cluster_tile`,
    `_route`): the cluster route while the card runs a cluster per tile at
    once, its tile width, and that no public function took an argument for
    it (tests/test_torch_fused_rk4_cluster.py holds the
    route itself on the card);
  * the route's product variant, which the libraries take from the widths
    and the tile width (chip_smoke.py's `expected_products`, which the card
    holds the libraries to, against the rule's constants in the kernels'
    header), the wide route for widths no variant runs, and the per-variant
    launch counters.
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import expected_bwd_sizes, expected_products
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.ops import pallas_rk4 as jfused
from hybrid_ode_torch.ops import fused_rk4 as tfused
from hybrid_ode_torch.utils import profiling
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

CTX_PARAMS = ("G_b", "I_b", "Glu_b")
_WIDE = Path(tfused.__file__).resolve().parents[1] / "csrc" / "fused_rk4_wide.cuh"
#: samples per tile, read from the kernels' header: Python keeps no copy
TILE = int(re.search(r"constexpr int WTILE = (\d+);", _WIDE.read_text()).group(1))
#: CTAs of a tile on the cluster route, read from the same header
CLUSTER = int(re.search(r"constexpr int CLUSTER = (\d+);", _WIDE.read_text()).group(1))
#: the cluster route's variants: the hidden width they are built for and the
#: widest tile that takes 'narrow', read from the same header
TILED_H = int(re.search(r"constexpr int TILED_H = (\d+);", _WIDE.read_text()).group(1))
WIDEST_NARROW_TILE = int(re.search(r"constexpr int WIDEST_NARROW_TILE = (\d+);",
                                _WIDE.read_text()).group(1))
#: threads of a block (CTA), read from the shared header
NTHREADS = int(re.search(r"constexpr int NTHREADS = (\d+);",
                         _WIDE.with_name("fused_rk4_common.cuh").read_text()).group(1))


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-8)


def _random_mlp(rng, in_dim, hidden, n_layers):
    dims = [in_dim] + [hidden] * n_layers + [6]
    nn = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        nn[f"w{i}"] = torch.tensor(rng.normal(size=(a, b)).astype(np.float32))
        nn[f"b{i}"] = torch.tensor(rng.normal(size=b).astype(np.float32))
    return nn


@pytest.mark.parametrize("mlp_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("in_dim,hidden,n_layers", [(9, 16, 1), (25, 128, 4), (12, 20, 2), (9, 64, 3)])
def test_transposed_weight_copy_round_trips_and_multiplies(in_dim, hidden, n_layers, mlp_dtype):
    rng = np.random.default_rng(in_dim + hidden)
    pw = tfused._pack_weights(_random_mlp(rng, in_dim, hidden, n_layers), n_layers)
    flat = tfused._kernel_weights(pw, mlp_dtype)
    both = tfused._kernel_weights(pw, mlp_dtype, transposed=True)
    n_w = pw.flat.numel()
    n_bias = n_layers * pw.hidden + tfused.N_OUT
    assert both.numel() == 2 * n_w - n_bias and both.is_contiguous()
    assert torch.equal(both[:n_w], flat)
    packed = tfused._unflatten(flat, pw.in_pad, pw.hidden, n_layers)
    off = n_w
    for w, (rows, cols) in zip(packed.ws, tfused._layer_shapes(pw.in_pad, pw.hidden, n_layers)):
        wt = both[off: off + rows * cols].view(cols, rows)  # (out, in) row-major
        off += rows * cols
        assert torch.equal(wt.t(), w)
        if mlp_dtype == "bf16":  # rounded before the copy was made
            assert torch.equal(wt, wt.to(torch.bfloat16).to(torch.float32))
        # the input cotangent u = W g, read by rows of the copy as the kernel does
        g = torch.tensor(rng.normal(size=(cols, 5)).astype(np.float32))
        u = (wt[:, :, None] * g[:, None, :]).sum(0)
        torch.testing.assert_close(u, w @ g, rtol=1e-5, atol=1e-5)
    assert off == both.numel()


SHAPES = [(B, C, H, L, s) for B in (2, TILE - 1, TILE + 1, 8192)
          for C, H, L, s in ((0, 16, 2, 1), (16, 128, 4, 4), (4, 20, 1, 2), (0, 64, 4, 4))]


@pytest.mark.parametrize("B,C,H,L,substeps", SHAPES)
def test_bwd_workspace_matches_the_kernel_formula(B, C, H, L, substeps):
    rng = np.random.default_rng(0)
    pw = tfused._pack_weights(_random_mlp(rng, 9 + C, H, L), L)
    n_w = pw.flat.numel()
    tiles, scratch_floats, partials_floats = expected_bwd_sizes(B, pw.in_pad, pw.hidden, L,
                                                                substeps, TILE)
    assert partials_floats == n_w, "the formula's partials are the packed weights and biases"
    sizes = tfused.BwdSizes(TILE, min(tiles, 132), scratch_floats, partials_floats, True)
    partials, scratch = tfused._bwd_workspace(sizes, n_w, "meta")
    assert partials.shape == (sizes.grid, n_w) and partials.dtype == torch.float32
    assert scratch.shape == (sizes.grid, scratch_floats) and scratch.dtype == torch.float32
    with pytest.raises(RuntimeError, match="partials"):
        tfused._bwd_workspace(sizes._replace(partials=n_w + 4), n_w, "meta")


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,L,substeps", SHAPES)
def test_cuda_library_reports_the_formula_sizes(B, C, H, L, substeps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the library is built and asked there)")
    in_pad = -(-(9 + C) // 8) * 8
    # the wide route's sizes, whichever route the rule gives these shapes
    got = tfused._bwd_sizes(B, C, in_pad, H, L, substeps, False, 0, torch.cuda.current_device())
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    tiles, *want = expected_bwd_sizes(B, in_pad, H, L, substeps, TILE)
    assert got.tile == tfused.fwd_tile() == TILE
    assert [got.scratch, got.partials] == want
    assert got.grid == tiles or (got.grid % blocks == 0 and got.grid < tiles)



def _case(context, n_layers, B, T=5, H=16, seed=0):
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
    tgt = rng.normal(size=(B, T, 6)).astype(np.float32)
    return p, y0, ts, meal, tvns, ctx, tgt


@pytest.mark.parametrize("B,context", [(2, "mul"), (TILE - 1, "features"), (TILE + 1, "none")])
def test_batches_at_the_tile_edge_match_jax(B, context):
    n_layers, substeps = 2, 2
    p, y0, ts, meal, tvns, ctx, tgt = _case(context, n_layers, B)
    idx = tuple(tfused.PARAM_ORDER.index(n) for n in CTX_PARAMS) if context == "mul" else ()
    kw = dict(substeps=substeps, n_layers=n_layers, context_param_idx=idx)

    def jpred(ode, nn, y0_, ctx_):
        return jfused.fused_rk4_hybrid(y0_, jnp.asarray(ts), jnp.asarray(meal), jnp.asarray(tvns),
                                       ode, nn, interpret=True, context=ctx_, **kw)

    argnums = (0, 1, 2, 3) if ctx is not None else (0, 1, 2)
    jctx = None if ctx is None else jnp.asarray(ctx)
    jtraj = jpred(p["ode"], p["nn"], jnp.asarray(y0), jctx)
    jg = jax.grad(lambda *a: jnp.sum(jpred(*a) * tgt), argnums=argnums)(
        p["ode"], p["nn"], jnp.asarray(y0), jctx)

    ode, nn = params_from_numpy(p["ode"], "cpu"), params_from_numpy(p["nn"], "cpu")
    for t in (*ode.values(), *nn.values()):
        t.requires_grad_(True)
    ty0 = torch.tensor(y0, requires_grad=True)
    tctx = None if ctx is None else torch.tensor(ctx, requires_grad=True)
    pred = tfused.fused_rk4_hybrid(ty0, torch.as_tensor(ts), torch.as_tensor(meal),
                                   torch.as_tensor(tvns), ode, nn, context=tctx, **kw)
    assert pred.shape == (B, ts.shape[1], 6)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jtraj), rtol=2e-4, atol=2e-4)
    (pred * torch.as_tensor(tgt)).sum().backward()
    assert _rel_err(jg[2], ty0.grad.numpy()) < 1e-5, "y0"
    for k in p["nn"]:
        assert _rel_err(jg[1][k], nn[k].grad.numpy()) < 1e-5, k
    for k in tfused.PARAM_ORDER:
        assert _rel_err(jg[0][k], ode[k].grad.numpy()) < 1e-5, k
    if ctx is not None:
        assert _rel_err(jg[3], tctx.grad.numpy()) < 1e-5, "context"


@pytest.mark.parametrize("B,sms,cluster", [(B, 132, True) for B in (1, 32, 64, 1024)]
                         + [(B, 132, False) for B in (1025, 8192)]
                         + [(896, 114, True), (1024, 114, False), (65, 8, False), (64, 8, True)])
def test_route_rule_follows_the_batch_and_the_multiprocessor_count(B, sms, cluster):
    """A card that runs every cluster its SMs hold at once (one CTA of a
    cluster kernel per SM)."""
    assert tfused._cluster_route(B, TILE, sms // CLUSTER) is cluster


@pytest.mark.parametrize("B,at_once,cluster", [(960, 15, True), (961, 15, False), (1024, 15, False),
                                               (1024, 16, True), (32, 1, True), (65, 1, False)])
def test_route_rule_takes_no_more_tiles_than_clusters_run_at_once(B, at_once, cluster):
    """An H100 SXM's GPCs run 15 clusters of 8 at once, not 132 // 8 = 16:
    a 16th tile would wait for a second wave."""
    assert tfused._cluster_route(B, TILE, at_once) is cluster


@pytest.mark.parametrize("B,tw", [(1, 4), (3, 4), (5, 8), (32, 32), (33, 36), (63, 64), (64, 64),
                                  (200, 64), (1024, 64)])
def test_cluster_tile_is_the_batch_rounded_up_to_4_at_most_a_wide_tile(B, tw):
    assert tfused._cluster_tile(B, TILE) == tw


@pytest.mark.parametrize("B,fits,route,want", [
    (32, True, None, "cluster"), (1024, True, None, "cluster"), (1025, True, None, "wide"),
    (32, False, None, "wide"), (32, True, "wide", "wide"), (8192, True, "cluster", "cluster")])
def test_route_tile_applies_the_rule_unless_a_route_is_forced(monkeypatch, B, fits, route, want):
    monkeypatch.setattr(tfused, "fwd_tile", lambda: TILE)
    tw = tfused._cluster_tile(B, TILE)
    got = tfused._route(B, tw, 132 // CLUSTER, fits, route)
    assert got == (tw if want == "cluster" else 0)


def test_route_tile_refuses_an_unknown_route_and_widths_that_do_not_fit():
    with pytest.raises(ValueError, match="unknown route"):
        tfused._route(32, 32, 16, True, "tiles")
    with pytest.raises(ValueError, match="do not fit"):
        tfused._route(32, 32, 16, False, "cluster")


#: the public functions' parameters: the route is chosen from the input alone
PUBLIC_PARAMETERS = {
    "fused_rk4_fwd": ["y0", "ts_t", "meal_t", "tvns_t", "ctx_t", "pw", "pvec", "substeps",
                      "ctx_param_idx", "ctx_param_mode", "mlp_dtype"],
    "fused_rk4_bwd": ["traj", "gbar", "ts_t", "meal_t", "tvns_t", "ctx_t", "pw", "pvec",
                      "substeps", "ctx_param_idx", "ctx_param_mode", "mlp_dtype"],
    "fused_rk4_bwd_vjp": ["traj", "gbar", "ts_t", "meal_t", "tvns_t", "ctx_t", "pw", "pvec",
                          "substeps", "ctx_param_idx", "ctx_param_mode", "mlp_dtype", "bwd_impl"],
    "bwd_sizes": ["B", "C", "in_pad", "hidden", "n_layers", "substeps", "mlp_dtype", "device"],
    "fused_rk4_hybrid": ["y0", "ts", "meal", "tvns", "ode_params", "nn_params", "substeps",
                         "n_layers", "context", "context_param_idx", "mlp_dtype",
                         "ctx_param_mode", "bwd_impl"],
    "fused_rk4_trajectory": ["args", "kwargs"],
    "pack": ["y0", "ts", "meal", "tvns", "ode_params", "nn_params", "n_layers", "context"],
}


@pytest.mark.parametrize("name", sorted(PUBLIC_PARAMETERS))
def test_no_public_function_gains_an_argument_for_the_route(name):
    params = list(inspect.signature(getattr(tfused, name)).parameters)
    assert params == PUBLIC_PARAMETERS[name]


@pytest.mark.parametrize("in_pad,H,tw,want", [
    (32, 128, 4, "narrow"), (32, 128, 8, "narrow"), (32, 128, 12, "wide"), (32, 128, 16, "wide"),
    (32, 128, 20, "wide"), (32, 128, 32, "wide"), (32, 128, 36, "wide"), (32, 128, 64, "wide"),
    (16, 128, 4, "narrow"), (16, 128, 64, "wide"), (24, 128, 4, None),
    (40, 128, 32, None), (32, 64, 4, None), (32, 132, 32, None),
    (16, 20, 8, None)])
def test_cluster_products_follow_the_tile_width_and_the_widths(monkeypatch, in_pad, H, tw, want):
    """The recipe's widths (H = 128, in_pad 32; 16 without context) take one
    output a thread up to 8 samples and 2 x 2 tiles beyond; no variant runs
    other widths, which the rule sends to the wide route."""
    assert expected_products(in_pad, H, tw) == want
    monkeypatch.setattr(tfused, "fwd_tile", lambda: TILE)
    B = tw  # a batch that fills the tile
    assert tfused._route(B, tw, 132 // CLUSTER, want is not None, None) == (tw if want else 0)


@pytest.mark.parametrize("in_pad,H", [(16, 128), (32, 128), (8, 128), (24, 128), (40, 128),
                                      (32, 64), (32, 132), (16, 20)])
def test_cluster_products_take_only_a_variant_the_library_builds(in_pad, H):
    """chip_smoke.py's `expected_products`, which the card holds both
    libraries to, against the constants of `cluster_products`: at H =
    TILED_H with in_pad 16 or 32, 'narrow' up to WIDEST_NARROW_TILE samples and
    'wide' beyond, at every tile width; no variant elsewhere. The size
    queries report the variant as an index after PRODUCTS_NONE."""
    for tw in range(4, TILE + 1, 4):
        got = expected_products(in_pad, H, tw)
        if H != TILED_H or in_pad not in (16, 32):
            assert got is None, tw
        else:
            assert got == ("narrow" if tw <= WIDEST_NARROW_TILE else "wide"), tw
    names = [tfused._products(v) for v in range(len(tfused.PRODUCTS) + 1)]
    assert names == [None, "narrow", "wide"]


@pytest.mark.parametrize("tw", range(4, TILE + 1, 4))
def test_narrow_is_built_wherever_the_launcher_would_take_it(tw):
    """'narrow' gives a 16-row slice's outputs a thread each, in whole warps:
    every tile width the library takes it at is a power of 2 whose outputs
    of a CTA's rows are at most its threads."""
    got = expected_products(32, TILED_H, tw)
    assert got == ("narrow" if tw <= WIDEST_NARROW_TILE else "wide")
    if got == "narrow":
        assert tw & (tw - 1) == 0 and (TILED_H // CLUSTER) * tw <= NTHREADS


def test_variant_counters_add_up_to_the_cluster_launches(monkeypatch):
    names = ["fused_rk4_cluster_launches"] + [f"fused_rk4_cluster_{v}_launches"
                                              for v in tfused.PRODUCTS]
    for name in names:
        monkeypatch.setattr(tfused, name, 0)
    for v in ("narrow", "wide", "wide", "narrow", "wide"):
        tfused._count_cluster(v)
    assert [getattr(tfused, n) for n in names] == [5, 2, 3]
    registered = set(profiling.counters())
    assert {f"fused_rk4.{n}" for n in names} <= registered
