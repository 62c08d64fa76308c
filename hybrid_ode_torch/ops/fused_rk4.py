"""Fused full-trajectory RK4 for the hybrid ODE-NN field: forward and adjoint.

Port of `hybrid_ode_tpu/ops/pallas_rk4.py`. Its three TPU kernels become
hand-written CUDA kernels for sm_90a, built with nvcc at first use and bound
with ctypes:
  * `_fwd_kernel` -> `csrc/fused_rk4_fwd.cu`: integrates the whole
    trajectory and writes the state at every observation point;
  * `_bwd_kernel_hand` -> `csrc/fused_rk4_bwd.cu`: the reverse-time discrete
    RK4 adjoint from the saved observation-grid trajectory, with the MLP and
    mechanistic transposes written by hand (`bwd_impl='hand'`, the default);
  * `_bwd_kernel` -> `csrc/fused_rk4_bwd_vjp.cu`: the same adjoint derived a
    second time, as the reverse sweep that differentiating one RK4 substep
    generates, in two schedules (`bwd_impl='recompute'`, `'chained'`) and
    six timing probes (`'probe_*'`, partial gradients by design).
All three work on 64-sample tiles with the MLP weights staged layer by
layer in shared memory and share the forward products
(`csrc/fused_rk4_wide.cuh`); each adjoint keeps its own transposes. The
forward and the hand adjoint have a second route for small batches: a tile
of min(64, B rounded up to 4) samples on a cluster of CTAs that split every
product's output rows and keep their weight slices in shared memory
(`_cluster_route` says when; the results equal the wide route's bitwise). It
is built for the shipped models' widths only, in one product variant per
tile width (PRODUCTS), which the libraries choose; other widths take the
wide route.
Every tile, grid and buffer size, and which widths the cluster route runs,
comes from the libraries (`fwd_tile`, `bwd_sizes`, `vjp_sizes`): this module
holds no copy of a kernel constant.
Beside each lives its plain PyTorch version (`_fwd_plain`, `_bwd_plain`,
`_bwd_vjp_plain`), the same function in torch ops on the same (features,
batch) layout; `_bwd_vjp_plain` takes its transposes from torch autograd.

`fused_rk4_fwd`, `fused_rk4_bwd` and `fused_rk4_bwd_vjp` are the wrappers: on
CPU tensors they run the plain version, on CUDA tensors they launch the
kernel (and count the launch in `fused_rk4_fwd_launches` /
`fused_rk4_bwd_launches` / `fused_rk4_bwd_vjp_launches`) or raise. There is
no fallback between the two. `FusedRK4` pairs them as a
`torch.autograd.Function`; `fused_rk4_hybrid` is the differentiable entry.

`mlp_dtype='bf16'`: every MLP product (forward and transposed) takes its
operands rounded to bf16, round to nearest even, and accumulates in f32;
biases, ReLU, states, the mechanistic drift, the RK combination and every
cotangent accumulator stay f32. The kernels get the weights rounded once.

Layouts (the kernels', equivalent to the TPU packing):
  * y0 (B, 6); ts / meal / tvns transposed to (T, B); context to (C, B).
  * MLP weights keep the (in, out) layout, layer 0's input padded to a
    multiple of 8, hidden widths to a multiple of 4, the last layer's output
    to 8 rows; all layers then all biases in one flat f32 buffer.
  * mechanistic parameters packed in PARAM_ORDER into a (32,) row.
  * trajectory and its cotangent (T, 6, B), returned to callers as (B, T, 6).
GD is 0 on this path (k_GE = k_GE0) and the insulin coupling is fixed at
0.01, exactly as in the TPU kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from hybrid_ode_torch.utils.profiling import span

#: mech-param packing order for the (32,) parameter row
PARAM_ORDER = (
    "a_GI", "k_I", "rho", "G_b", "I_b", "E_max", "EC_50", "Glu_b",
    "V_max", "K_m", "k_L", "k_GE0", "IGD_50", "g", "p_7", "p_8", "p_9",
)
N_PARAMS = len(PARAM_ORDER)
N_FEATURES = 9  # [t, y(6), GLP1, tVNS] before the context rows
N_OUT = 8       # last layer's output rows (6 states + 2 zero rows)

#: kernel launches since the count was last set to 0 (plain runs do not count)
fused_rk4_fwd_launches = 0
fused_rk4_bwd_launches = 0
fused_rk4_bwd_vjp_launches = 0
#: of the forward and hand-adjoint launches, those that took the cluster route
fused_rk4_cluster_launches = 0
#: of those, the launches of each product variant (PRODUCTS); they add up to
#: fused_rk4_cluster_launches
fused_rk4_cluster_narrow_launches = 0
fused_rk4_cluster_wide_launches = 0

MLP_DTYPES = ("f32", "bf16")
#: bwd_impl of the second-derivation adjoint -> (schedule, differentiates the
#: weights, ... the parameters and context, field parts, forward-only passes)
VJP_IMPLS = {
    "recompute": ("recompute", True, True, "both", 0),
    "chained": ("chained", True, True, "both", 0),
    "probe_y": ("chained", False, False, "both", 0),
    "probe_yw": ("chained", True, False, "both", 0),
    "probe_y_mlp": ("chained", False, False, "mlp", 0),
    "probe_y_mech": ("chained", False, False, "mech", 0),
    "probe_fwd1": ("chained", False, False, "both", 1),
    "probe_fwd2": ("chained", False, False, "both", 2),
}
BWD_IMPLS = ("hand", *VJP_IMPLS)
#: partitions of a tile the forward and the hand adjoint can launch on
ROUTES = ("wide", "cluster")
#: the cluster route's product variants, in the libraries' order (Products in
#: csrc/fused_rk4_wide.cuh, after PRODUCTS_NONE): one output a thread; 2 x 2
#: tiles. The libraries take one from the tile width and report it.
PRODUCTS = ("narrow", "wide")

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"
# -fmad=false: outside the explicit fmaf of the matmul loops, every product
# and sum rounds on its own, as the plain version's tensor ops do, so the
# adjoint's recomputed ReLU masks agree with the plain version's
# --split-compile 0: a source's kernels are optimised in parallel on all cores
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "--split-compile", "0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: further nvcc arguments of the libraries the wrappers launch. Empty but in
#: kernel_cuts.py, which sets -DFUSED_RK4_CUT=<bits> (csrc/fused_rk4_wide.cuh)
#: to time the kernels with a part left out.
KERNEL_DEFINES: Tuple[str, ...] = ()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class PackedWeights(NamedTuple):
    """MLP weights in the kernel layout; `ws`/`bs` are views into `flat`."""

    flat: torch.Tensor
    ws: Tuple[torch.Tensor, ...]  # (in_pad, out_pad) per layer
    bs: Tuple[torch.Tensor, ...]  # (out_pad,) per layer
    in_pad: int
    hidden: int                   # padded hidden width
    n_layers: int


def _layer_shapes(in_pad: int, hidden: int, n_layers: int) -> List[Tuple[int, int]]:
    return [(in_pad if i == 0 else hidden, N_OUT if i == n_layers else hidden)
            for i in range(n_layers + 1)]


def _unflatten(flat: torch.Tensor, in_pad: int, hidden: int, n_layers: int) -> PackedWeights:
    """Views of the per-layer weights and biases inside `flat`."""
    shapes = _layer_shapes(in_pad, hidden, n_layers)
    ws, bs, off = [], [], 0
    for shape in shapes:
        ws.append(flat[off: off + shape[0] * shape[1]].view(shape))
        off += shape[0] * shape[1]
    for _, cols in shapes:
        bs.append(flat[off: off + cols])
        off += cols
    if off != flat.numel():
        raise ValueError(f"flat weights hold {flat.numel()} values, the layout {off}")
    return PackedWeights(flat, tuple(ws), tuple(bs), in_pad, hidden, n_layers)


def _pack_weights(nn_params: Dict[str, torch.Tensor], n_layers: int) -> PackedWeights:
    """Pad the MLP weights to the kernel layout (see module docstring).

    Built from differentiable ops (`F.pad`, `cat`), so a gradient of `flat`
    reaches `nn_params` through autograd."""
    w0 = nn_params["w0"]
    in_dim, hid = w0.shape
    if any(f"w{i}" not in nn_params for i in range(n_layers + 1)) or f"w{n_layers + 1}" in nn_params:
        raise ValueError(f"nn params do not hold exactly {n_layers + 1} layers")
    if nn_params[f"w{n_layers}"].shape[1] > N_OUT:
        raise ValueError("the last layer has more than 8 outputs")
    in_pad, hp = _round_up(in_dim, 8), _round_up(hid, 4)
    ws, bs = [], []
    for i, (rows, cols) in enumerate(_layer_shapes(in_pad, hp, n_layers)):
        w = nn_params[f"w{i}"].to(torch.float32)
        b = nn_params[f"b{i}"].to(torch.float32)
        if i > 0 and w.shape[0] != hid or i < n_layers and w.shape[1] != hid:
            raise ValueError(f"layer {i} has shape {tuple(w.shape)}; hidden width is {hid}")
        ws.append(F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0])).reshape(-1))
        bs.append(F.pad(b, (0, cols - b.shape[0])))
    return _unflatten(torch.cat(ws + bs), in_pad, hp, n_layers)


def _pack_params(ode_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(32,) f32 row of the mechanistic parameters in PARAM_ORDER."""
    vals = [torch.as_tensor(ode_params[n]).to(torch.float32).reshape(1) for n in PARAM_ORDER]
    pad = torch.zeros((32 - N_PARAMS,), dtype=torch.float32, device=vals[0].device)
    return torch.cat(vals + [pad])


def _prep_inputs(y0, ts, meal, tvns, context):
    """To the kernel layout: f32, contiguous, time / context transposed."""
    f32 = torch.float32
    ctx_t = None if context is None else context.to(f32).t().contiguous()
    return (y0.to(f32).contiguous(), ts.to(f32).t().contiguous(),
            meal.to(f32).t().contiguous(), tvns.to(f32).t().contiguous(), ctx_t)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """Round a Python float to f32, as the kernel's float arithmetic does."""
    return torch.tensor(x, dtype=torch.float32).item()


def _effective_params(pvec, ctx_t, ctx_param_idx, ctx_param_mode) -> Dict[str, torch.Tensor]:
    """PARAM_ORDER name -> scalar, or a per-sample row where the context acts."""
    P = {name: pvec[i] for i, name in enumerate(PARAM_ORDER)}
    for row, pidx in enumerate(ctx_param_idx):
        name = PARAM_ORDER[pidx]
        c = ctx_t[row]
        P[name] = c if ctx_param_mode == "abs" else P[name] * torch.exp(c)
    return P


def _fixed_features(ctx_t, ctx_param_idx, in_pad, B, like) -> List[torch.Tensor]:
    """MLP feature rows after the first 9: feature-mode context, zero pad."""
    feats_ctx = None if ctx_param_idx else ctx_t  # params mode consumes the context
    n_feat = N_FEATURES + (0 if feats_ctx is None else feats_ctx.shape[0])
    fixed = [] if feats_ctx is None else [feats_ctx]
    if in_pad > n_feat:
        fixed.append(torch.zeros((in_pad - n_feat, B), dtype=like.dtype, device=like.device))
    return fixed


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundOperand(torch.autograd.Function):
    """x rounded to bf16; the cotangent passes through as it is."""

    @staticmethod
    def forward(ctx, x):
        return _bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Identity whose cotangent is rounded to bf16: placed on a product's
    output, it makes the transposed products take that operand rounded."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g)


def _operand(mlp_dtype: str):
    """What an MLP product does to an operand: bf16 rounding or nothing."""
    return _RoundOperand.apply if mlp_dtype == "bf16" else (lambda x: x)


def _stage_eval(t, Y, m, v, P, fixed, pw: PackedWeights, mlp_dtype: str = "f32",
                parts: str = "both"):
    """One field evaluation: (k (6, B), features X, post-ReLU activations).
    `parts` 'mlp' / 'mech' keeps only that part of the field (timing probes)."""
    G, I, Glu, GLP1, FFA = Y[0], Y[1], Y[2], Y[3], Y[5]
    Pi = 1.0 + P["rho"] * GLP1
    dI = Pi * P["a_GI"] * (G - P["G_b"]) - P["k_I"] * (I - P["I_b"])
    glp1_eff = P["E_max"] * GLP1 / (P["EC_50"] + GLP1)
    dGlu = -glp1_eff * (Glu - P["Glu_b"])
    dGLP1 = P["V_max"] * G / (P["K_m"] + G) - P["k_L"] * GLP1
    dFFA = -P["p_7"] * FFA - P["p_8"] * I * FFA + P["p_9"] * G * FFA
    dG = m - 0.01 * (I - P["I_b"]) + 0.005 * (Glu - P["Glu_b"]) - P["k_GE0"] * G
    dY = torch.stack([dG, dI, dGlu, dGLP1, torch.zeros_like(G), dFFA])
    X = torch.cat([t[None], Y, GLP1[None], v[None]] + fixed)
    if parts == "mech":
        return dY, X, []
    rnd = _operand(mlp_dtype)
    out = _RoundCotangent.apply if mlp_dtype == "bf16" else (lambda x: x)
    acts, Hh = [], X
    for li in range(pw.n_layers):
        Hh = torch.relu(out(rnd(pw.ws[li]).t() @ rnd(Hh)) + pw.bs[li][:, None])
        acts.append(Hh)
    R = out(rnd(pw.ws[pw.n_layers]).t() @ rnd(Hh)) + pw.bs[pw.n_layers][:, None]
    return (R[:6] if parts == "mlp" else dY + R[:6]), X, acts


def _substep(Y, ts_l, ts_r, meal_l, meal_r, tvns_l, tvns_r, j, substeps, P, fixed, pw,
             mlp_dtype: str = "f32", parts: str = "both"):
    """One RK4 substep as the kernels take it; returns (Y', h, [(X, acts)] x 4)."""
    inv_s = _f32(1.0 / substeps)
    h = (ts_r - ts_l) * inv_s
    t = ts_l + float(j) * h

    def ctrl(alpha):
        a = _f32(_f32(alpha) * inv_s)
        return meal_l + (meal_r - meal_l) * a, tvns_l + (tvns_r - tvns_l) * a

    (m0, v0), (m1, v1), (m2, v2) = ctrl(j), ctrl(j + 0.5), ctrl(j + 1.0)
    opt = (mlp_dtype, parts)
    k1, X1, a1 = _stage_eval(t, Y, m0, v0, P, fixed, pw, *opt)
    k2, X2, a2 = _stage_eval(t + 0.5 * h, Y + 0.5 * h * k1, m1, v1, P, fixed, pw, *opt)
    k3, X3, a3 = _stage_eval(t + 0.5 * h, Y + 0.5 * h * k2, m1, v1, P, fixed, pw, *opt)
    k4, X4, a4 = _stage_eval(t + h, Y + h * k3, m2, v2, P, fixed, pw, *opt)
    Y = Y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return Y, h, ((X1, a1), (X2, a2), (X3, a3), (X4, a4))


def _fwd_plain(y0, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
               substeps: int, ctx_param_idx: Sequence[int] = (),
               ctx_param_mode: str = "mul", mlp_dtype: str = "f32") -> torch.Tensor:
    """The forward kernel's function in torch ops, on its inputs: (T, 6, B)."""
    P = _effective_params(pvec, ctx_t, ctx_param_idx, ctx_param_mode)
    fixed = _fixed_features(ctx_t, ctx_param_idx, pw.in_pad, y0.shape[0], y0)
    Y = y0.t()
    out = [Y]
    for i in range(ts_t.shape[0] - 1):
        for j in range(substeps):
            Y, _, _ = _substep(Y, ts_t[i], ts_t[i + 1], meal_t[i], meal_t[i + 1],
                               tvns_t[i], tvns_t[i + 1], j, substeps, P, fixed, pw, mlp_dtype)
        out.append(Y)
    return torch.stack(out)


def _stage_bwd(gd, X, acts, P, pw: PackedWeights, acc, mlp_dtype: str = "f32"):
    """Transpose of `_stage_eval` for the field cotangent gd (6, B): returns
    the stage-state cotangent (6, B) and adds the weight, bias, per-sample
    parameter and feature-mode context cotangents into `acc`
    (`_bwd_kernel_hand.stage_bwd`, pallas_rk4.py:522-604). With
    mlp_dtype='bf16' both operands of every product are rounded first."""
    dws, dbs, dp, dctx = acc["dw"], acc["db"], acc["dp"], acc["dctx"]
    L = pw.n_layers
    rnd = _operand(mlp_dtype)
    g = F.pad(gd, (0, 0, 0, N_OUT - 6))
    dws[L] += rnd(acts[L - 1]) @ rnd(g).t()
    dbs[L] += g.sum(1)
    u = rnd(pw.ws[L]) @ rnd(g)
    for li in range(L - 1, -1, -1):
        gz = u * (acts[li] > 0)
        inp = acts[li - 1] if li > 0 else X
        dws[li] += rnd(inp) @ rnd(gz).t()
        dbs[li] += gz.sum(1)
        u = rnd(pw.ws[li]) @ rnd(gz)
    dX = u
    if dctx is not None:
        dctx += dX[N_FEATURES: N_FEATURES + dctx.shape[0]]

    # mechanistic transpose (hand-derived Jacobian rows)
    G, I, Glu, GLP1, FFA = X[1], X[2], X[3], X[4], X[6]
    gG, gI, gGlu, gGLP, gFFA = gd[0], gd[1], gd[2], gd[3], gd[5]
    Pi = 1.0 + P["rho"] * GLP1
    Gd = G - P["G_b"]
    Glud = Glu - P["Glu_b"]
    e_den = P["EC_50"] + GLP1
    glp1_eff = P["E_max"] * GLP1 / e_den
    km_den = P["K_m"] + G
    mech_G = (gI * (Pi * P["a_GI"]) + gGLP * (P["V_max"] * P["K_m"] / (km_den * km_den))
              + gFFA * (P["p_9"] * FFA) - gG * P["k_GE0"])
    mech_I = -gI * P["k_I"] - gFFA * (P["p_8"] * FFA) - 0.01 * gG
    mech_Glu = -gGlu * glp1_eff + 0.005 * gG
    mech_GLP = (gI * (P["rho"] * P["a_GI"] * Gd)
                - gGlu * (Glud * P["E_max"] * P["EC_50"] / (e_den * e_den))
                - gGLP * P["k_L"])
    mech_FFA = gFFA * (-P["p_7"] - P["p_8"] * I + P["p_9"] * G)
    dY = torch.stack([dX[1] + mech_G, dX[2] + mech_I, dX[3] + mech_Glu,
                      dX[4] + dX[7] + mech_GLP, dX[5], dX[6] + mech_FFA])

    # per-sample cotangent rows of the EFFECTIVE parameters
    terms = {
        "a_GI": gI * Pi * Gd,
        "k_I": -(gI * (I - P["I_b"])),
        "rho": gI * P["a_GI"] * Gd * GLP1,
        "G_b": -(gI * Pi * P["a_GI"]),
        "I_b": gI * P["k_I"] + 0.01 * gG,
        "E_max": -(gGlu * Glud * GLP1 / e_den),
        "EC_50": gGlu * Glud * P["E_max"] * GLP1 / (e_den * e_den),
        "Glu_b": gGlu * glp1_eff - 0.005 * gG,
        "V_max": gGLP * G / km_den,
        "K_m": -(gGLP * P["V_max"] * G / (km_den * km_den)),
        "k_L": -(gGLP * GLP1),
        "k_GE0": -(gG * G),
        "p_7": -(gFFA * FFA),
        "p_8": -(gFFA * I * FFA),
        "p_9": gFFA * G * FFA,
    }
    for name, term in terms.items():
        dp[PARAM_ORDER.index(name)] += term
    return dY


def _bwd_plain(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
               substeps: int, ctx_param_idx: Sequence[int] = (),
               ctx_param_mode: str = "mul", mlp_dtype: str = "f32"):
    """The backward kernel's function in torch ops, on its inputs.

    traj / gbar (T, 6, B): the forward's trajectory and its cotangent.
    Returns (ybar0 (B, 6), dflat (shaped as pw.flat), dp (17, B) per-sample
    parameter cotangents, dctx (B, C) or None). Walks the intervals in
    reverse; per interval one forward pass from traj[i] keeps every stage's
    features and activations, then each substep's stages are transposed in
    the order 4, 3, 2, 1 (pallas_rk4.py:606-647)."""
    T, _, B = traj.shape
    L = pw.n_layers
    P = _effective_params(pvec, ctx_t, ctx_param_idx, ctx_param_mode)
    fixed = _fixed_features(ctx_t, ctx_param_idx, pw.in_pad, B, traj)
    feature_ctx = ctx_t is not None and not ctx_param_idx
    acc = {"dw": [torch.zeros_like(w) for w in pw.ws],
           "db": [torch.zeros_like(b) for b in pw.bs],
           "dp": torch.zeros((N_PARAMS, B), dtype=traj.dtype, device=traj.device),
           "dctx": torch.zeros_like(ctx_t) if feature_ctx else None}
    ybar = gbar[T - 1]
    for i in range(T - 2, -1, -1):
        Y = traj[i]
        saved = []
        for j in range(substeps):
            Y, h, stages = _substep(Y, ts_t[i], ts_t[i + 1], meal_t[i], meal_t[i + 1],
                                    tvns_t[i], tvns_t[i + 1], j, substeps, P, fixed, pw,
                                    mlp_dtype)
            saved.append((h, stages))
        for h, stages in reversed(saved):
            go = ybar
            dk4 = (h / 6.0) * go
            dY4 = _stage_bwd(dk4, *stages[3], P, pw, acc, mlp_dtype)
            dk3 = (h / 3.0) * go + h * dY4
            dY3 = _stage_bwd(dk3, *stages[2], P, pw, acc, mlp_dtype)
            dk2 = (h / 3.0) * go + 0.5 * h * dY3
            dY2 = _stage_bwd(dk2, *stages[1], P, pw, acc, mlp_dtype)
            dk1 = (h / 6.0) * go + 0.5 * h * dY2
            dY1 = _stage_bwd(dk1, *stages[0], P, pw, acc, mlp_dtype)
            ybar = go + dY1 + dY2 + dY3 + dY4
        ybar = ybar + gbar[i]

    dp, dctx = acc["dp"], acc["dctx"]
    if ctx_param_idx:  # closed-form fold of the effective-parameter cotangents
        rows = []
        for row, pidx in enumerate(ctx_param_idx):
            if ctx_param_mode == "abs":
                rows.append(dp[pidx].clone())
                dp[pidx] = 0.0
            else:  # P_eff = base * e^c
                rows.append(dp[pidx] * P[PARAM_ORDER[pidx]])
                dp[pidx] = dp[pidx] * torch.exp(ctx_t[row])
        dctx = torch.stack(rows)
    dflat = torch.cat([w.reshape(-1) for w in acc["dw"]] + acc["db"])
    return ybar.t(), dflat, dp, None if dctx is None else dctx.t()


def _bwd_vjp_plain(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
                   substeps: int, ctx_param_idx: Sequence[int] = (),
                   ctx_param_mode: str = "mul", mlp_dtype: str = "f32",
                   bwd_impl: str = "recompute"):
    """The second-derivation adjoint kernel's function, its transposes taken
    from `torch.autograd.grad` through the plain `_substep`, substep by
    substep (as `jax.vjp` of `_rk4_substep_t` in `_bwd_kernel`,
    pallas_rk4.py:692); nothing here is shared with `_bwd_plain`'s transposes.

    Returns (ybar0 (B, 6), dflat, dp, dctx (B, C) or None) as `_bwd_plain`
    does, except that 'recompute' returns dp as the (32,) row summed over the
    batch. 'recompute' rebuilds the substep states of an interval first and
    then differentiates each substep from its saved state; 'chained' and the
    probes keep every substep's graph from one forward pass. What a probe
    leaves out is zero."""
    schedule, diff_w, diff_p, parts, fwd_passes = VJP_IMPLS[bwd_impl]
    T, _, B = traj.shape
    with torch.enable_grad():
        flat = pw.flat.detach().requires_grad_(diff_w)
        pw_l = _unflatten(flat, pw.in_pad, pw.hidden, pw.n_layers)
        if schedule == "recompute":  # the packed row: cotangents summed over the batch
            pv = pvec.detach().requires_grad_(True)
        else:  # 17 per-sample rows: cotangents stay per sample
            pv = pvec.detach()[:N_PARAMS, None].expand(N_PARAMS, B).clone().requires_grad_(diff_p)
        ctx_l = None if ctx_t is None else ctx_t.detach().requires_grad_(diff_p)
        wrt = {name: x for name, x in (("flat", flat), ("pv", pv), ("ctx", ctx_l))
               if x is not None and x.requires_grad}
        sums = {name: torch.zeros_like(x) for name, x in wrt.items()}

        def step(Y, i, j):
            P = _effective_params(pv, ctx_l, ctx_param_idx, ctx_param_mode)
            fixed = _fixed_features(ctx_l, ctx_param_idx, pw.in_pad, B, traj)
            return _substep(Y, ts_t[i], ts_t[i + 1], meal_t[i], meal_t[i + 1], tvns_t[i],
                            tvns_t[i + 1], j, substeps, P, fixed, pw_l, mlp_dtype, parts)[0]

        ybar = gbar[T - 1]
        for i in range(T - 2, -1, -1):
            if fwd_passes:  # timing probes: forward passes only
                with torch.no_grad():
                    last = traj[i]
                    for _ in range(fwd_passes):
                        Y = traj[i] + 1e-30 * last
                        for j in range(substeps):
                            Y = step(Y, i, j)
                        last = Y
                ybar = ybar + 1e-30 * last + gbar[i]
                continue
            pairs = []  # (input state, output state) of each substep
            Y = traj[i]
            for j in range(substeps):
                Y_in = Y.detach().requires_grad_(True)
                if schedule == "recompute":
                    with torch.no_grad():
                        Y = step(Y_in, i, j)
                    pairs.append((Y_in, None))
                else:
                    Y = step(Y_in, i, j)
                    pairs.append((Y_in, Y))
            for j in range(substeps - 1, -1, -1):
                Y_in, Y_out = pairs[j]
                if Y_out is None:
                    Y_out = step(Y_in, i, j)
                grads = torch.autograd.grad(Y_out, [Y_in, *wrt.values()], ybar,
                                            allow_unused=True)
                ybar = grads[0]
                for name, g in zip(sums, grads[1:]):
                    if g is not None:
                        sums[name] += g
            ybar = ybar + gbar[i]

    def total(name, like):  # what was not differentiated is zero
        return sums[name] if name in sums else torch.zeros_like(like)

    dctx = None if ctx_t is None else total("ctx", ctx_t).t()
    return ybar.detach().t(), total("flat", flat), total("pv", pv), dctx


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the fused RK4 kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _headers() -> List[Path]:
    return sorted(_CSRC.glob("*.cuh"))


def build_library(defines: Sequence[str] = ()) -> Dict[str, Tuple[Path, str]]:
    """Compile every csrc/*.cu into its own library in `hybrid_ode_torch/build/`
    unless a build of these exact sources and headers (and `defines`, further
    nvcc arguments) is there; the nvcc runs start together. Returns
    {source stem: (path, nvcc output)}."""
    h = hashlib.sha256("\0".join(defines).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    tag = h.hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _sources():
        so = _BUILD_DIR / f"lib{src.stem}_{tag}.so"
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[src.stem] = (so, tmp, subprocess.Popen(
                [_find_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for stem, (so, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu ({proc.returncode}):\n{out}")
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    built = {}
    for src in _sources():
        so = _BUILD_DIR / f"lib{src.stem}_{tag}.so"
        log = so.with_suffix(".log")
        built[src.stem] = (so, log.read_text() if log.exists() else "")
    return built


def _libraries() -> Dict[str, ctypes.CDLL]:
    return _load_libraries(tuple(KERNEL_DEFINES))


@functools.lru_cache(maxsize=None)
def _load_libraries(defines: Tuple[str, ...]) -> Dict[str, ctypes.CDLL]:
    libs = {stem: ctypes.CDLL(str(so)) for stem, (so, _) in build_library(defines).items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    sizes = ctypes.POINTER(ctypes.c_longlong)
    fwd = libs["fused_rk4_fwd"].fused_rk4_fwd
    fwd.argtypes = [p] * 9 + [i] * 11 + [p]
    fwd.restype = i
    libs["fused_rk4_fwd"].fused_rk4_fwd_tile.argtypes = [ctypes.POINTER(i)]
    libs["fused_rk4_fwd"].fused_rk4_fwd_tile.restype = i
    libs["fused_rk4_fwd"].fused_rk4_fwd_cluster.argtypes = [i] * 4 + [sizes]
    libs["fused_rk4_fwd"].fused_rk4_fwd_cluster.restype = i
    bwd_lib = libs["fused_rk4_bwd"]
    bwd_lib.fused_rk4_bwd_grid.argtypes = [i] * 8 + [sizes]
    bwd_lib.fused_rk4_bwd_grid.restype = i
    bwd_lib.fused_rk4_bwd.argtypes = [p] * 15 + [i] * 13 + [p]
    bwd_lib.fused_rk4_bwd.restype = i
    vjp_lib = libs["fused_rk4_bwd_vjp"]
    vjp_lib.fused_rk4_bwd_vjp_sizes.argtypes = [i] * 8 + [sizes]
    vjp_lib.fused_rk4_bwd_vjp_sizes.restype = i
    vjp_lib.fused_rk4_bwd_vjp.argtypes = [p] * 17 + [i] * 15 + [p]
    vjp_lib.fused_rk4_bwd_vjp.restype = i
    return libs


def _check(name: str, x: torch.Tensor, shape, dtype=torch.float32) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(T, B, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec, ctx_param_idx):
    """Shared argument checks of both launchers; returns (C, n_cp)."""
    C = 0 if ctx_t is None else ctx_t.shape[0]
    for name, x in (("ts", ts_t), ("meal", meal_t), ("tvns", tvns_t)):
        _check(name, x, (T, B))
    if ctx_t is not None:
        _check("context", ctx_t, (C, B))
    H, L = pw.hidden, pw.n_layers
    _check("weights", pw.flat, (pw.in_pad * H + (L - 1) * H * H + H * N_OUT + L * H + N_OUT,))
    _check("pvec", pvec, (32,))
    n_cp = len(ctx_param_idx)
    if n_cp and n_cp != C:
        raise ValueError(f"{n_cp} context parameters but {C} context rows")
    if not n_cp and pw.in_pad < N_FEATURES + C:
        raise ValueError(f"layer 0 takes {pw.in_pad} inputs, fewer than {N_FEATURES + C}")
    return C, n_cp


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _cidx(ctx_param_idx, dev):
    if not ctx_param_idx:
        return None
    with span("hode.sync.copy"):  # from host memory: the copy waits for the card's queue
        return torch.tensor(list(ctx_param_idx), dtype=torch.int32, device=dev)


def _kernel_weights(pw: PackedWeights, mlp_dtype: str, transposed: bool = False) -> torch.Tensor:
    """The flat weights as the kernels read them: for 'bf16' a copy whose
    weights (not the biases behind them) are rounded to bf16 once. With
    `transposed` (the hand adjoint) every layer's weights follow once more as
    (out, in) row-major, in the layers' order: its transposed products then
    read rows where the packed layout has columns."""
    flat = pw.flat
    if mlp_dtype == "bf16":
        n_bias = pw.n_layers * pw.hidden + N_OUT
        flat = flat.clone()
        flat[:-n_bias] = _bf16(flat[:-n_bias])
    if not transposed:
        return flat
    ws = _unflatten(flat, pw.in_pad, pw.hidden, pw.n_layers).ws
    return torch.cat([flat] + [w.t().reshape(-1) for w in ws])


class BwdSizes(NamedTuple):
    """What the hand adjoint's library reports for a launch (fused_rk4_bwd_grid)."""

    tile: int           # samples per tile
    grid: int           # slices of scratch and partials: blocks, or clusters on the cluster route
    scratch: int        # floats of scratch per slice
    partials: int       # floats of weight-cotangent partials per slice
    staged: bool        # weights staged through (or kept in) shared memory
    route: str = "wide"  # a name in ROUTES
    cluster: int = 1    # CTAs per slice: 1 on the wide route
    at_once: int = 0    # on the cluster route, the clusters the card runs at once
    products: Optional[str] = None  # on the cluster route, the variant it launches (PRODUCTS)


class VjpSizes(NamedTuple):
    """What the second-derivation adjoint's library reports for a launch
    (fused_rk4_bwd_vjp_sizes)."""

    tile: int           # samples per block tile
    grid: int           # blocks to launch
    scratch: int        # floats of scratch per block (stage slots x floats per slot)
    partials: int       # floats of weight-cotangent partials per block
    staged: bool        # weights staged through shared memory (the fast route)
    smem: int           # bytes of shared memory per block


@functools.lru_cache(maxsize=None)
def fwd_tile() -> int:
    """Samples per block tile of the forward kernel, as its library reports it
    (a constant of the library, asked once)."""
    tile = ctypes.c_int(0)
    err = _libraries()["fused_rk4_fwd"].fused_rk4_fwd_tile(ctypes.byref(tile))
    if err != 0:
        raise RuntimeError(f"fused_rk4_fwd_tile failed: cudaError {err}")
    return tile.value


def _cluster_route(B: int, tile: int, at_once: int) -> bool:
    """The route rule: the cluster route where the card runs a cluster for
    each `tile`-sample tile of the wide route at once (`at_once`, which the
    libraries ask of `cudaOccupancyMaxActiveClusters`: it follows the card's
    SM count, and its GPCs bound it below SMs / cluster size), so that no
    tile waits for a second wave and loses to the wide route (one SM per
    tile); the wide route otherwise. An H100 SXM runs 15 clusters of 8 at
    once: B <= 960."""
    return -(-B // tile) <= at_once


def _cluster_tile(B: int, tile: int) -> int:
    """Samples per tile on the cluster route: the wide route's `tile`, or B
    rounded up to 4 where that is fewer, so that a small batch masks no lane."""
    return min(tile, _round_up(B, 4))


def _products(v: int) -> Optional[str]:
    """The name in PRODUCTS of the libraries' variant v (Products), None for
    PRODUCTS_NONE."""
    return PRODUCTS[v - 1] if v else None


def _count_cluster(products: str) -> None:
    """Count a cluster-route launch of product variant `products` (PRODUCTS)."""
    global fused_rk4_cluster_launches
    global fused_rk4_cluster_narrow_launches, fused_rk4_cluster_wide_launches
    fused_rk4_cluster_launches += 1
    if products == "narrow":
        fused_rk4_cluster_narrow_launches += 1
    else:
        fused_rk4_cluster_wide_launches += 1


def _route(B: int, tw: int, at_once: int, fits: bool, route: Optional[str]) -> int:
    """The launch's tile width: 0 for the wide route, `tw` for the cluster
    route. `route` None applies `_cluster_route` where the cluster route
    runs the widths (`fits`: a product variant is built for them and a CTA
    holds them); a name of ROUTES forces it (tests and chip_smoke.py)."""
    if route is None:
        route = "cluster" if fits and _cluster_route(B, fwd_tile(), at_once) else "wide"
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {ROUTES}")
    if route == "cluster" and not fits:
        raise ValueError("these widths do not fit the cluster route: no product variant "
                         "runs them, or a CTA cannot hold them")
    return tw if route == "cluster" else 0


@functools.lru_cache(maxsize=None)
def _fwd_cluster(in_pad: int, hidden: int, n_layers: int, tw: int,
                 index: int) -> Tuple[bool, int, Optional[str]]:
    """(whether the route runs these widths, clusters card `index` runs at
    once, the variant it launches for them: a name in PRODUCTS or None) of
    the forward's cluster route at tile width tw, asked of the library once."""
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(index):
        err = _libraries()["fused_rk4_fwd"].fused_rk4_fwd_cluster(in_pad, hidden, n_layers, tw,
                                                                  out)
    if err != 0:
        raise RuntimeError(f"fused_rk4_fwd_cluster failed: cudaError {err}")
    return bool(out[1]), int(out[3]), _products(out[4])


def _card_index(device) -> int:
    """The CUDA card `device` names (the current one when it names none): the
    libraries' sizes are cached per card."""
    index = None if device is None else torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def bwd_sizes(B: int, C: int, in_pad: int, hidden: int, n_layers: int, substeps: int,
              mlp_dtype: str = "f32", device=None) -> BwdSizes:
    """Route, tile, grid and per-slice buffer sizes of a hand-adjoint launch on
    these shapes, asked of the library: Python holds no copy of a kernel
    constant."""
    return _bwd_route(B, C, in_pad, hidden, n_layers, substeps, mlp_dtype == "bf16",
                      _card_index(device), None)


def _bwd_route(B, C, in_pad, hidden, n_layers, substeps, bf16: bool, index: int,
               route: Optional[str]) -> BwdSizes:
    """The hand adjoint's sizes on `route` (None: the rule)."""
    shape = (B, C, in_pad, hidden, n_layers, substeps, bf16)
    tw = _cluster_tile(B, fwd_tile())
    got = _bwd_sizes(*shape, tw, index)
    tw = _route(B, tw, 0 if got is None else got.at_once, got is not None, route)
    return _bwd_sizes(*shape, tw, index)


@functools.lru_cache(maxsize=None)
def _bwd_sizes(B, C, in_pad, hidden, n_layers, substeps, bf16: bool, tw: int,
               index: int) -> Optional[BwdSizes]:
    """The library's answer for one shape and route (tile width tw, 0 for the
    wide route) on card `index`, asked once; None where the cluster route
    does not run these widths."""
    out = (ctypes.c_longlong * 9)()
    with torch.cuda.device(index):
        err = _libraries()["fused_rk4_bwd"].fused_rk4_bwd_grid(
            B, C, in_pad, hidden, n_layers, substeps, int(bf16), tw, out)
    if err != 0:
        raise RuntimeError(f"fused_rk4_bwd_grid failed: cudaError {err}")
    if not out[6]:
        return None
    return BwdSizes(int(out[0]), int(out[1]), int(out[2]), int(out[3]), bool(out[4]),
                    ROUTES[bool(tw)], int(out[5]), int(out[7]), _products(out[8]))


def vjp_sizes(B: int, C: int, in_pad: int, hidden: int, n_layers: int, substeps: int,
              bwd_impl: str = "recompute", mlp_dtype: str = "f32", device=None) -> VjpSizes:
    """Tile, grid, per-block buffer sizes, route and shared memory of a
    second-derivation launch on these shapes, asked of the library."""
    recompute = VJP_IMPLS[bwd_impl][0] == "recompute"
    return _vjp_sizes(B, C, in_pad, hidden, n_layers, substeps, recompute, mlp_dtype == "bf16",
                      _card_index(device))


@functools.lru_cache(maxsize=None)
def _vjp_sizes(B, C, in_pad, hidden, n_layers, substeps, recompute: bool, bf16: bool,
               index: int) -> VjpSizes:
    """The library's answer for one shape and schedule on card `index`, asked once."""
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(index):
        err = _libraries()["fused_rk4_bwd_vjp"].fused_rk4_bwd_vjp_sizes(
            B, C, in_pad, hidden, n_layers, substeps, int(not recompute), int(bf16), out)
    if err != 0:
        raise RuntimeError(f"fused_rk4_bwd_vjp_sizes failed: cudaError {err}")
    return VjpSizes(int(out[0]), int(out[1]), int(out[2]), int(out[3]), bool(out[4]), int(out[5]))


def _bwd_workspace(sizes, n_w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partials (grid, n_w), scratch (grid, floats per block)) for a launch
    of either adjoint (`sizes`: BwdSizes or VjpSizes)."""
    if sizes.partials != n_w:
        raise RuntimeError(f"the library's partials hold {sizes.partials} floats per block, "
                           f"the packed weights {n_w}")
    return (torch.empty((sizes.grid, n_w), dtype=torch.float32, device=device),
            torch.empty((sizes.grid, sizes.scratch), dtype=torch.float32, device=device))


def _fwd_cuda(y0, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
              substeps: int, ctx_param_idx: Sequence[int] = (),
              ctx_param_mode: str = "mul", mlp_dtype: str = "f32",
              route: Optional[str] = None) -> torch.Tensor:
    """Launch the forward kernel on its inputs: (T, 6, B). `route` forces a
    name of ROUTES; None takes the rule (`_cluster_route`)."""
    global fused_rk4_fwd_launches
    B = y0.shape[0]
    T = ts_t.shape[0]
    _check("y0", y0, (B, 6))
    C, n_cp = _check_common(T, B, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, ctx_param_idx)
    dev = y0.device
    tw = _cluster_tile(B, fwd_tile())
    fits, at_once, products = _fwd_cluster(pw.in_pad, pw.hidden, pw.n_layers, tw,
                                           _card_index(dev))
    tw = _route(B, tw, at_once, fits, route)
    cidx = _cidx(ctx_param_idx, dev)
    out = torch.empty((T, 6, B), dtype=torch.float32, device=dev)
    weights = _kernel_weights(pw, mlp_dtype)
    lib = _libraries()["fused_rk4_fwd"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rk4_fwd(
            _ptr(y0), _ptr(ts_t), _ptr(meal_t), _ptr(tvns_t), _ptr(ctx_t), _ptr(weights),
            _ptr(pvec), _ptr(cidx), _ptr(out), B, T, C, pw.in_pad, pw.hidden, pw.n_layers,
            substeps, n_cp, int(ctx_param_mode == "abs"), int(mlp_dtype == "bf16"), tw, stream)
    if err != 0:
        raise RuntimeError(f"fused_rk4_fwd launch failed: cudaError {err}")
    fused_rk4_fwd_launches += 1
    if tw:
        _count_cluster(products)
    return out


def fused_rk4_fwd(y0, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
                  substeps: int, ctx_param_idx: Sequence[int] = (),
                  ctx_param_mode: str = "mul", mlp_dtype: str = "f32") -> torch.Tensor:
    """The forward kernel on CUDA tensors, its plain version on CPU tensors."""
    if y0.device.type == "cpu":
        return _fwd_plain(y0, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                          ctx_param_idx, ctx_param_mode, mlp_dtype)
    if y0.device.type != "cuda":
        raise ValueError(f"fused_rk4_fwd runs on CUDA or CPU tensors, got {y0.device}")
    return _fwd_cuda(y0, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                     ctx_param_idx, ctx_param_mode, mlp_dtype)


def _bwd_cuda(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
              substeps: int, ctx_param_idx: Sequence[int] = (),
              ctx_param_mode: str = "mul", mlp_dtype: str = "f32",
              route: Optional[str] = None):
    """Launch the backward kernel; returns what `_bwd_plain` returns. `route`
    forces a name of ROUTES; None takes the rule (`_cluster_route`).

    Each block (each cluster, on the cluster route) accumulates the weight
    cotangents of the samples it walks into its own slice of `partials`; a
    second kernel sums the slices in order, so the result does not depend
    on scheduling. The library says how many slices it wants and how much
    scratch each needs."""
    global fused_rk4_bwd_launches
    T, _, B = traj.shape
    _check("traj", traj, (T, 6, B))
    _check("gbar", gbar, (T, 6, B))
    C, n_cp = _check_common(T, B, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, ctx_param_idx)
    dev = traj.device
    lib = _libraries()["fused_rk4_bwd"]
    H, L, in_pad = pw.hidden, pw.n_layers, pw.in_pad
    bf16 = int(mlp_dtype == "bf16")
    sizes = _bwd_route(B, C, in_pad, H, L, substeps, bool(bf16), _card_index(dev), route)
    tw = sizes.tile if sizes.route == "cluster" else 0
    n_w = pw.flat.numel()
    empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    ybar0, dp, dflat = empty((B, 6)), empty((N_PARAMS, B)), empty((n_w,))
    dctx = empty((B, C)) if C else None
    partials, scratch = _bwd_workspace(sizes, n_w, dev)
    cidx = _cidx(ctx_param_idx, dev)
    weights = _kernel_weights(pw, mlp_dtype, transposed=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rk4_bwd(
            _ptr(traj), _ptr(gbar), _ptr(ts_t), _ptr(meal_t), _ptr(tvns_t), _ptr(ctx_t),
            _ptr(weights), _ptr(pvec), _ptr(cidx), _ptr(ybar0), _ptr(dp), _ptr(dctx),
            _ptr(dflat), _ptr(partials), _ptr(scratch), B, T, C, in_pad, H, L, substeps,
            n_cp, int(ctx_param_mode == "abs"), bf16, sizes.grid, n_w, tw, stream)
    if err != 0:
        raise RuntimeError(f"fused_rk4_bwd launch failed: cudaError {err}")
    fused_rk4_bwd_launches += 1
    if tw:
        _count_cluster(sizes.products)
    return ybar0, dflat, dp, dctx


def fused_rk4_bwd(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
                  substeps: int, ctx_param_idx: Sequence[int] = (),
                  ctx_param_mode: str = "mul", mlp_dtype: str = "f32"):
    """The backward kernel on CUDA tensors, its plain version on CPU tensors."""
    if traj.device.type == "cpu":
        return _bwd_plain(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                          ctx_param_idx, ctx_param_mode, mlp_dtype)
    if traj.device.type != "cuda":
        raise ValueError(f"fused_rk4_bwd runs on CUDA or CPU tensors, got {traj.device}")
    return _bwd_cuda(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                     ctx_param_idx, ctx_param_mode, mlp_dtype)


def _bwd_vjp_cuda(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
                  substeps: int, ctx_param_idx: Sequence[int] = (),
                  ctx_param_mode: str = "mul", mlp_dtype: str = "f32",
                  bwd_impl: str = "recompute"):
    """Launch the second-derivation adjoint kernel; returns what
    `_bwd_vjp_plain` returns. Weight cotangents go through per-block slices
    of `partials` summed in block order, as in `_bwd_cuda`; for 'recompute'
    so do the parameter cotangents, one (32,) row per block. The library
    says how many blocks it wants and how much scratch each needs."""
    global fused_rk4_bwd_vjp_launches
    schedule, diff_w, diff_p, parts, fwd_passes = VJP_IMPLS[bwd_impl]
    T, _, B = traj.shape
    _check("traj", traj, (T, 6, B))
    _check("gbar", gbar, (T, 6, B))
    C, n_cp = _check_common(T, B, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, ctx_param_idx)
    dev = traj.device
    lib = _libraries()["fused_rk4_bwd_vjp"]
    H, L, in_pad = pw.hidden, pw.n_layers, pw.in_pad
    bf16 = int(mlp_dtype == "bf16")
    recompute = schedule == "recompute"
    sizes = vjp_sizes(B, C, in_pad, H, L, substeps, bwd_impl, mlp_dtype, dev)
    n_w = pw.flat.numel()
    partials, scratch = _bwd_workspace(sizes, n_w, dev)
    empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    ybar0, dflat = empty((B, 6)), empty((n_w,))
    dp = None if recompute else empty((N_PARAMS, B))
    dpv, dpv_part = (empty((32,)), empty((sizes.grid, 32))) if recompute else (None, None)
    dctx = empty((B, C)) if C else None
    cidx = _cidx(ctx_param_idx, dev)
    weights = _kernel_weights(pw, mlp_dtype)
    flags = (1 * diff_w + 2 * diff_p + 4 * (parts == "mech") + 8 * (parts == "mlp"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rk4_bwd_vjp(
            _ptr(traj), _ptr(gbar), _ptr(ts_t), _ptr(meal_t), _ptr(tvns_t), _ptr(ctx_t),
            _ptr(weights), _ptr(pvec), _ptr(cidx), _ptr(ybar0), _ptr(dp), _ptr(dpv),
            _ptr(dpv_part), _ptr(dctx), _ptr(dflat), _ptr(partials), _ptr(scratch),
            B, T, C, in_pad, H, L, substeps, n_cp, int(ctx_param_mode == "abs"), bf16,
            sizes.grid, n_w, int(not recompute), flags, fwd_passes, stream)
    if err != 0:
        raise RuntimeError(f"fused_rk4_bwd_vjp launch failed: cudaError {err}")
    fused_rk4_bwd_vjp_launches += 1
    return ybar0, dflat, dpv if recompute else dp, dctx


def fused_rk4_bwd_vjp(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw: PackedWeights, pvec,
                      substeps: int, ctx_param_idx: Sequence[int] = (),
                      ctx_param_mode: str = "mul", mlp_dtype: str = "f32",
                      bwd_impl: str = "recompute"):
    """The second-derivation adjoint kernel on CUDA tensors, its plain
    version on CPU tensors; `bwd_impl` is a key of VJP_IMPLS."""
    if bwd_impl not in VJP_IMPLS:
        raise ValueError(f"unknown bwd_impl {bwd_impl!r} for this kernel; one of {tuple(VJP_IMPLS)}")
    if traj.device.type == "cpu":
        return _bwd_vjp_plain(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                              ctx_param_idx, ctx_param_mode, mlp_dtype, bwd_impl)
    if traj.device.type != "cuda":
        raise ValueError(f"fused_rk4_bwd_vjp runs on CUDA or CPU tensors, got {traj.device}")
    return _bwd_vjp_cuda(traj, gbar, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                         ctx_param_idx, ctx_param_mode, mlp_dtype, bwd_impl)


# ---------------------------------------------------------------------------
# Differentiable public API
# ---------------------------------------------------------------------------

class FusedRK4(torch.autograd.Function):
    """Fused trajectory (B, T, 6) with an adjoint kernel as its backward:
    the hand adjoint, or for another `bwd_impl` the second derivation
    (the JAX package's `_make_fused_rk4` custom VJP, pallas_rk4.py:1016)."""

    @staticmethod
    def forward(ctx, y0, ts_t, meal_t, tvns_t, ctx_t, flat, pvec, layout, substeps,
                ctx_param_idx, ctx_param_mode, mlp_dtype="f32", bwd_impl="hand"):
        pw = _unflatten(flat, *layout)
        traj = fused_rk4_fwd(y0, ts_t, meal_t, tvns_t, ctx_t, pw, pvec, substeps,
                             ctx_param_idx, ctx_param_mode, mlp_dtype)
        ctx.save_for_backward(traj, ts_t, meal_t, tvns_t, ctx_t, flat, pvec)
        ctx.static = (layout, substeps, ctx_param_idx, ctx_param_mode, mlp_dtype, bwd_impl)
        return traj.permute(2, 0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        traj, ts_t, meal_t, tvns_t, ctx_t, flat, pvec = ctx.saved_tensors
        layout, substeps, ctx_param_idx, ctx_param_mode, mlp_dtype, bwd_impl = ctx.static
        gbar = g.to(torch.float32).permute(1, 2, 0).contiguous()
        args = (traj, gbar, ts_t, meal_t, tvns_t, ctx_t, _unflatten(flat, *layout), pvec,
                substeps, ctx_param_idx, ctx_param_mode, mlp_dtype)
        if bwd_impl == "hand":
            ybar0, dflat, dp, dctx = fused_rk4_bwd(*args)
        else:
            ybar0, dflat, dp, dctx = fused_rk4_bwd_vjp(*args, bwd_impl)
        # per-sample rows -> (32,); 'recompute' has summed them already
        dpvec = dp if dp.ndim == 1 else F.pad(dp.sum(1), (0, 32 - N_PARAMS))
        dctx_t = None if dctx is None else dctx.t()
        return (ybar0, None, None, None, dctx_t, dflat, dpvec) + (None,) * 6


def pack(y0, ts, meal, tvns, ode_params, nn_params, n_layers: int = 4,
         context: Optional[torch.Tensor] = None):
    """Kernel inputs for `fused_rk4_fwd` from the (B, ...) public layout."""
    return (*_prep_inputs(y0, ts, meal, tvns, context),
            _pack_weights(nn_params, n_layers), _pack_params(ode_params))


def fused_rk4_hybrid(
    y0: torch.Tensor,                 # (B, 6) states
    ts: torch.Tensor,                 # (B, T) per-sample time grids (hours)
    meal: torch.Tensor,               # (B, T) meal signal on the grid
    tvns: torch.Tensor,               # (B, T) tVNS signal on the grid
    ode_params: Dict[str, torch.Tensor],
    nn_params: Dict[str, torch.Tensor],
    substeps: int = 4,
    n_layers: int = 4,
    context: Optional[torch.Tensor] = None,  # (B, C) per-sample features
    context_param_idx: tuple = (),
    mlp_dtype: str = "f32",
    ctx_param_mode: str = "mul",
    bwd_impl: str = "hand",
) -> torch.Tensor:
    """Differentiable fused-RK4 trajectory (B, T, 6): forward kernel, an
    adjoint kernel as its backward. Gradients reach y0, context, ode_params
    and nn_params; ts, meal and tvns are data and get none.

    Equivalent to `odeint(hybrid_field, ..., solver='rk4', substeps=s)` with
    linear control interpolation. `context_param_idx` (PARAM_ORDER indices)
    selects `context_mode='params'`: the context rows then act on those
    mechanistic parameters ('mul': P * e^c, 'abs': P = c) and the MLP sees
    no context.

    mlp_dtype='bf16' rounds the operands of every MLP product, forward and
    transposed, to bf16 with f32 accumulation (see the module docstring):
    trajectories and gradients then agree with 'f32' to bf16 resolution.

    bwd_impl: 'hand' (default) is the hand-transposed adjoint; 'recompute'
    and 'chained' are the two schedules of the second derivation, kept to
    check 'hand' against and to compare; the 'probe_*' values are its timing
    decompositions and return partial gradients by design (BWD_IMPLS)."""
    if mlp_dtype not in MLP_DTYPES:
        raise ValueError(f"unknown mlp_dtype {mlp_dtype!r}")
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}; one of {BWD_IMPLS}")
    if ctx_param_mode not in ("mul", "abs"):
        raise ValueError(f"unknown ctx_param_mode {ctx_param_mode!r}")
    if substeps < 1 or n_layers < 1:
        raise ValueError("substeps and n_layers must be >= 1")
    if context_param_idx and (context is None or context.shape[-1] != len(context_param_idx)):
        raise ValueError("context_param_idx needs one context column per parameter")
    if context is not None and not context_param_idx and \
            nn_params["w0"].shape[0] != N_FEATURES + context.shape[-1]:
        raise ValueError(f"layer 0 takes {nn_params['w0'].shape[0]} inputs, not "
                         f"{N_FEATURES} + {context.shape[-1]} context features")
    y0_k, ts_t, meal_t, tvns_t, ctx_t, pw, pvec = pack(y0, ts, meal, tvns, ode_params,
                                                       nn_params, n_layers, context)
    return FusedRK4.apply(y0_k, ts_t, meal_t, tvns_t, ctx_t, pw.flat, pvec,
                          (pw.in_pad, pw.hidden, pw.n_layers), substeps,
                          tuple(context_param_idx), ctx_param_mode, mlp_dtype, bwd_impl)


def fused_rk4_trajectory(*args, **kwargs) -> torch.Tensor:
    """`fused_rk4_hybrid` without autograd (forward kernel only); (B, T, 6)."""
    with torch.no_grad():
        return fused_rk4_hybrid(*args, **kwargs)
