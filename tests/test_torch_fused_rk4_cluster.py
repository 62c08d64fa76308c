"""The cluster route of the fused RK4 forward and hand adjoint, on the card.

Small batches run one tile of min(64, B rounded up to 4) samples on a
thread-block cluster whose CTAs split every product's output rows
(`hybrid_ode_torch/csrc/fused_rk4_wide.cuh`). Split by rows, never by the
contraction, every sum keeps the wide route's order, so the route's outputs
must equal the wide route's bitwise on the same inputs: trajectory, ybar0,
every weight and bias cotangent, dp and dctx. A leaf that may differ would
be named in BITWISE_EXCEPTIONS with its gap and held to the plain version
only; there is none. Both routes are also held to the plain versions at
chip_smoke.py phase 3's limits, and a second launch must repeat the first.
The route's product variants (`fused_rk4.PRODUCTS`, which the libraries take
from the tile width) are each held alike, at batches on the edges of their
tile widths; widths that no variant runs take the wide route, and forcing the
cluster route on them raises.

JAX-free: run on the card with
    python3 -m pytest tests/test_torch_fused_rk4_cluster.py --noconftest -q
Every test is `cuda`-marked and skips without a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_ode_torch.ops import fused_rk4

#: leaves allowed to differ from the wide route, with their measured gap
BITWISE_EXCEPTIONS = {}
CTX_PARAMS = ("G_b", "I_b", "Glu_b")
T, SUBSTEPS = 9, 2
_WIDE = Path(fused_rk4.__file__).resolve().parents[1] / "csrc" / "fused_rk4_wide.cuh"
#: samples per wide tile and CTAs per cluster, read from the kernels' header
TILE = int(re.search(r"constexpr int WTILE = (\d+);", _WIDE.read_text()).group(1))
CLUSTER = int(re.search(r"constexpr int CLUSTER = (\d+);", _WIDE.read_text()).group(1))
#: tests/test_torch_fused_rk4_layout.py's shapes of the library's sizes
SHAPES = [(B, C, H, L, s) for B in (2, TILE - 1, TILE + 1, 8192)
          for C, H, L, s in ((0, 16, 2, 1), (16, 128, 4, 4), (4, 20, 1, 2), (0, 64, 4, 4))]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, B, mode, hidden=128, n_layers=4, C=16, seed=0):
    """Kernel inputs for one case: features mode with C context features, or
    params mode ('mul' / 'abs') on three parameters; numpy from a seed."""
    rng = np.random.default_rng(seed + B)
    ode = chip_smoke.params_from_numpy(
        chip_smoke.load_checkpoint(str(chip_smoke.CKPT))[0]["params"], device)["ode"]
    y0 = (0.5 * rng.normal(size=(B, 6))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.05, 0.15, (B, T)), 1).astype(np.float32)
    meal = np.where(rng.uniform(size=(B, T)) > 0.7, 1.0, 0.0).astype(np.float32)
    tvns = rng.uniform(0, 1, (B, T)).astype(np.float32)
    idx, ctx, in_dim = (), None, 9
    if mode == "features":
        ctx, in_dim = (0.3 * rng.normal(size=(B, C))).astype(np.float32), 9 + C
    elif mode == "mul":
        idx = tuple(fused_rk4.PARAM_ORDER.index(n) for n in CTX_PARAMS)
        ctx = (0.2 * rng.normal(size=(B, 3))).astype(np.float32)
    else:
        idx = tuple(fused_rk4.PARAM_ORDER.index(n) for n in CTX_PARAMS)
        base = np.array([float(ode[n]) for n in CTX_PARAMS], np.float32)
        ctx = (base * (1 + 0.2 * rng.normal(size=(B, 3)))).astype(np.float32)
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    packed = fused_rk4.pack(t(y0), t(ts), t(meal), t(tvns), ode,
                            chip_smoke.random_mlp(rng, in_dim, hidden, n_layers, device),
                            n_layers, t(ctx))
    return packed, idx, "abs" if mode == "abs" else "mul"


def _both_routes(packed, idx, mode, mlp_dtype):
    """{route: (trajectory, adjoint leaves)} on the same inputs and cotangent."""
    out = {}
    gbar = None
    for route in fused_rk4.ROUTES:
        with torch.no_grad():
            traj = fused_rk4._fwd_cuda(*packed, SUBSTEPS, idx, mode, mlp_dtype, route=route)
            if gbar is None:
                gbar = torch.as_tensor(np.random.default_rng(1).normal(
                    size=traj.shape).astype(np.float32), device=traj.device)
            leaves = chip_smoke.bwd_leaves(fused_rk4._bwd_cuda(
                traj, gbar, *packed[1:], SUBSTEPS, idx, mode, mlp_dtype, route=route), packed[5])
        torch.cuda.synchronize()
        out[route] = (traj, leaves)
    return out


def _gap(a, b):
    return float((a.double() - b.double()).abs().max())


#: tile widths 4 and 8 ('narrow'), then 12, 16, 20, 32, 36, 64 ('wide')
CASES = [(B, mode, dtype) for B in (1, 4, 5, 8, 9, 16, 17, 32, 33, 64, 200)
         for mode in ("features", "mul", "abs") for dtype in ("f32", "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,mode,mlp_dtype", CASES)
def test_cluster_route_equals_the_wide_route_and_the_plain_versions(device, B, mode, mlp_dtype):
    packed, idx, m = _case(device, B, mode)
    runs = _both_routes(packed, idx, m, mlp_dtype)
    (traj_c, leaves_c), (traj_w, leaves_w) = runs["cluster"], runs["wide"]
    assert torch.equal(traj_c, traj_w), f"trajectory differs by {_gap(traj_c, traj_w):.3e}"
    differ = {n: _gap(leaves_c[n], leaves_w[n]) for n in leaves_w
              if not torch.equal(leaves_c[n], leaves_w[n])}
    assert set(differ) <= set(BITWISE_EXCEPTIONS), f"leaves differ from the wide route: {differ}"
    # both routes against the plain versions at phase 3's limits
    with torch.no_grad():
        plain = fused_rk4._fwd_plain(*packed, SUBSTEPS, idx, m, mlp_dtype)
    if mlp_dtype == "f32":
        chip_smoke.compare(traj_c, plain, f"cluster route B={B} {mode}")
        chip_smoke.compare_bwd(packed, T, SUBSTEPS, f"cluster route B={B} {mode}", idx, m,
                               full=True)
    else:
        assert chip_smoke.rel_err(plain, traj_c) <= chip_smoke.BF16_SMALL_RTOL
        chip_smoke.compare_bwd(packed, T, SUBSTEPS, f"cluster route B={B} {mode}", idx, m,
                               mlp_dtype="bf16", limit=chip_smoke.BF16_SMALL_RTOL)


def _variant_counts():
    return {v: getattr(fused_rk4, f"fused_rk4_cluster_{v}_launches") for v in fused_rk4.PRODUCTS}


@pytest.mark.cuda
@pytest.mark.parametrize("B,variant", [(4, "narrow"), (8, "narrow"), (9, "wide"), (32, "wide"),
                                       (200, "wide")])
def test_cluster_route_repeats_itself_bitwise_and_counts_its_launches(device, B, variant):
    packed, idx, m = _case(device, B, "features")
    before, variants = fused_rk4.fused_rk4_cluster_launches, _variant_counts()
    first, second = (_both_routes(packed, idx, m, "f32")["cluster"] for _ in range(2))
    assert fused_rk4.fused_rk4_cluster_launches - before == 4  # two forwards, two adjoints
    # the recipe's widths at this batch's tile width take `variant`, counted per variant
    after = _variant_counts()
    assert {v: after[v] - variants[v] for v in after} == {
        v: 4 if v == variant else 0 for v in fused_rk4.PRODUCTS}
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(first[1][n], second[1][n]) for n in first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("hidden,n_layers,C", [(20, 3, 4), (64, 1, 0), (132, 2, 16), (128, 3, 16),
                                               (128, 1, 0)])
def test_cluster_route_at_uneven_splits_and_odd_depth(device, hidden, n_layers, C, B):
    """Widths that no product variant runs (H = 20, 64, 132): the rule takes
    the wide route and a forced cluster route raises. An odd number of hidden
    layers (the last layer reads the buffer the next stage's first product
    fills) and in_pad = 16 (no context; 2 rows a CTA), at a 'narrow' and a
    'wide' tile width: the cluster route equals the wide route bitwise."""
    packed, idx, m = _case(device, B, "features" if C else "mul", hidden, n_layers, C)
    pw = packed[5]
    if hidden != 128:
        tw = fused_rk4._cluster_tile(B, TILE)
        assert chip_smoke.expected_products(pw.in_pad, pw.hidden, tw) is None
        rows = packed[4].shape[0]
        sizes = fused_rk4.bwd_sizes(B, rows, pw.in_pad, pw.hidden, n_layers, SUBSTEPS)
        assert sizes.route == "wide"
        launches = fused_rk4.fused_rk4_cluster_launches
        with torch.no_grad():
            traj = fused_rk4._fwd_cuda(*packed, SUBSTEPS, idx, m)
            fused_rk4._bwd_cuda(traj, torch.ones_like(traj), *packed[1:], SUBSTEPS, idx, m)
        torch.cuda.synchronize()
        assert fused_rk4.fused_rk4_cluster_launches == launches
        with pytest.raises(ValueError, match="do not fit"):
            fused_rk4._fwd_cuda(*packed, SUBSTEPS, idx, m, route="cluster")
        with pytest.raises(ValueError, match="do not fit"):
            fused_rk4._bwd_cuda(traj, torch.ones_like(traj), *packed[1:], SUBSTEPS, idx, m,
                                route="cluster")
        return
    runs = _both_routes(packed, idx, m, "f32")
    (traj_c, leaves_c), (traj_w, leaves_w) = runs["cluster"], runs["wide"]
    assert torch.equal(traj_c, traj_w), f"trajectory differs by {_gap(traj_c, traj_w):.3e}"
    differ = {n: _gap(leaves_c[n], leaves_w[n]) for n in leaves_w
              if not torch.equal(leaves_c[n], leaves_w[n])}
    assert not differ, f"leaves differ from the wide route: {differ}"


@pytest.mark.cuda
def test_the_rule_takes_the_cluster_route_at_the_recipe_batch_and_not_at_the_cohort(device):
    index = torch.cuda.current_device()
    tile = fused_rk4.fwd_tile()
    at_once = fused_rk4.bwd_sizes(1, 16, 32, 128, 4, 4).at_once
    pw = _case(device, 4, "features")[0][5]
    for B, want in ((32, True), (1, True), (tile * at_once, True), (tile * at_once + 1, False),
                    (8192, False)):
        got = fused_rk4.bwd_sizes(B, 16, 32, 128, 4, 4)
        assert (got.route == "cluster") == want, (B, got)
        assert (got.cluster > 1) == want
        tw = fused_rk4._cluster_tile(B, tile)
        fits, fwd_at_once, _ = fused_rk4._fwd_cluster(pw.in_pad, pw.hidden, pw.n_layers, tw, index)
        assert fused_rk4._route(B, tw, fwd_at_once, fits, None) == (tw if want else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,L,substeps", SHAPES)
def test_bwd_sizes_on_the_rule_route_are_the_formula_sizes(device, B, C, H, L, substeps):
    """`bwd_sizes` on the route the rule gives: on the cluster route its
    tile, clusters, scratch and partials are chip_smoke.py's formula's; on
    the wide route they are the wide route's."""
    in_pad = -(-(9 + C) // 8) * 8
    got = fused_rk4.bwd_sizes(B, C, in_pad, H, L, substeps)
    wide = fused_rk4._bwd_sizes(B, C, in_pad, H, L, substeps, False, 0,
                                torch.cuda.current_device())
    if got.route == "wide":  # more tiles than clusters at once, or widths a cluster cannot hold
        assert got == wide
        return
    assert -(-B // TILE) <= got.at_once and got.cluster == CLUSTER and got.staged
    want = chip_smoke.expected_cluster_bwd_sizes(B, in_pad, H, L, substeps, TILE, CLUSTER)
    assert [got.tile, got.grid, got.scratch, got.partials] == list(want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 16, 32, 64])
def test_every_product_variant_built_for_the_widths_equals_the_generic_one(device, B):
    """The variant both libraries take for the recipe's widths at this tile
    width is chip_smoke.py's formula's, and it is the one launched; against
    the generic products, the wide route's (which runs every width):
    trajectory and every adjoint leaf bitwise."""
    packed, idx, m = _case(device, B, "features")
    pw = packed[5]
    tw = fused_rk4._cluster_tile(B, TILE)
    chosen = fused_rk4._fwd_cluster(pw.in_pad, pw.hidden, pw.n_layers, tw,
                                    torch.cuda.current_device())[2]
    assert chosen == chip_smoke.expected_products(pw.in_pad, pw.hidden, tw) is not None
    sizes = fused_rk4.bwd_sizes(B, 16, pw.in_pad, pw.hidden, pw.n_layers, SUBSTEPS)
    assert sizes.route == "cluster" and sizes.products == chosen
    variants = _variant_counts()
    runs = _both_routes(packed, idx, m, "f32")
    after = _variant_counts()
    assert {v: after[v] - variants[v] for v in after} == {
        v: 2 if v == chosen else 0 for v in fused_rk4.PRODUCTS}  # a forward, an adjoint
    (traj_c, leaves_c), (traj_w, leaves_w) = runs["cluster"], runs["wide"]
    assert torch.equal(traj_c, traj_w), (
        f"{chosen}: trajectory differs by {_gap(traj_c, traj_w):.3e}")
    differ = {n: _gap(leaves_c[n], leaves_w[n]) for n in leaves_w
              if not torch.equal(leaves_c[n], leaves_w[n])}
    assert not differ, f"{chosen}: leaves differ from the wide route: {differ}"
