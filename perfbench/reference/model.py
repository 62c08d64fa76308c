"""The hybrid glucose model in plain PyTorch, float32, TF32 off.

A frozen copy of the model's equations, written from its description and
independent of the program under test:

    dG/dt    = meal - 0.01 (I - I_b) + 0.005 (Glu - Glu_b) - k_GE0 G
    dI/dt    = (1 + rho GLP1) a_GI (G - G_b) - k_I (I - I_b)
    dGlu/dt  = -E_max GLP1 / (EC_50 + GLP1) (Glu - Glu_b)
    dGLP1/dt = V_max G / (K_m + G) - k_L GLP1
    dGE/dt   = 0
    dFFA/dt  = -p_7 FFA - p_8 I FFA + p_9 G FFA
    + MLP([t, y(6), GLP1, tVNS, context]) -> 6 residuals (ReLU hidden layers)

(no gastric delay input: k_GE = k_GE0), the context encoder (an MLP on a
window's first k observations and their times since its start), RK4 with
controls interpolated linearly inside each output interval, and the
batched data loss. Every matrix product goes through `Arith.mm`, so the
control can run the same reference with its operands rounded to TF32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

ODE_NAMES = ("EC_50", "E_max", "G_b", "Glu_b", "IGD_50", "I_b", "K_m", "V_max", "a_GI",
             "g", "k_GE0", "k_I", "k_L", "p_7", "p_8", "p_9", "rho")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10-bit mantissa, to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and f32 accumulation, as the
    tensor cores multiply in TF32; the two products of its backward round
    their operands alike."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.t(), ra.t() @ rg


class Arith:
    """How the reference multiplies matrices: f32 (`tf32=False`, the
    reference) or in TF32 (the control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return a @ b


F32 = Arith(False)


def set_precision() -> None:
    """Plain f32 products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp(layers: Dict[str, torch.Tensor], x: torch.Tensor, arith: Arith = F32) -> torch.Tensor:
    """ReLU MLP with weights w0..wn (in, out) and biases b0..bn; x (..., in)."""
    n = sum(1 for k in layers if k.startswith("w"))
    h = x
    for i in range(n):
        w, b = layers[f"w{i}"], layers[f"b{i}"]
        h = arith.mm(h.reshape(-1, h.shape[-1]), w).reshape(h.shape[:-1] + (w.shape[1],)) + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def encode(enc: Dict[str, torch.Tensor], obs: torch.Tensor, ts: torch.Tensor, k: int,
           arith: Arith = F32) -> torch.Tensor:
    """Context codes (B, C) from each window's first k observations and their
    times since the window's start."""
    feats = torch.cat([obs[:, :k, :], (ts[:, :k] - ts[:, :1])[..., None]], dim=-1)
    return mlp(enc, feats.reshape(obs.shape[0], -1), arith)


def mech(y: torch.Tensor, P: Dict[str, torch.Tensor], meal: torch.Tensor) -> torch.Tensor:
    """The mechanistic drift; P's values are scalars or (B,) rows."""
    G, I, Glu, GLP1, FFA = y[:, 0], y[:, 1], y[:, 2], y[:, 3], y[:, 5]
    dI = (1.0 + P["rho"] * GLP1) * P["a_GI"] * (G - P["G_b"]) - P["k_I"] * (I - P["I_b"])
    dGlu = -(P["E_max"] * GLP1 / (P["EC_50"] + GLP1)) * (Glu - P["Glu_b"])
    dGLP1 = P["V_max"] * G / (P["K_m"] + G) - P["k_L"] * GLP1
    dFFA = -P["p_7"] * FFA - P["p_8"] * I * FFA + P["p_9"] * G * FFA
    dG = meal - 0.01 * (I - P["I_b"]) + 0.005 * (Glu - P["Glu_b"]) - P["k_GE0"] * G
    return torch.stack([dG, dI, dGlu, dGLP1, torch.zeros_like(G), dFFA], dim=1)


def field(t, y, meal, tvns, ctx: Optional[torch.Tensor], P, nn, arith: Arith = F32):
    """dy/dt of the hybrid model for states y (B, 6) at times t (B,)."""
    cols = [t[:, None], y, y[:, 3:4], tvns[:, None]]
    if ctx is not None:
        cols.append(ctx)
    return mech(y, P, meal) + mlp(nn, torch.cat(cols, dim=1), arith)


def rk4(y0, ts, meal, tvns, ctx, P, nn, substeps: int, arith: Arith = F32) -> torch.Tensor:
    """RK4 with `substeps` equal steps per output interval; the controls are
    linear between grid points. y0 (B, 6), ts / meal / tvns (B, T) ->
    (B, T, 6)."""
    y, out = y0, [y0]
    for i in range(ts.shape[1] - 1):
        tl, tr = ts[:, i], ts[:, i + 1]
        ml, mr, vl, vr = meal[:, i], meal[:, i + 1], tvns[:, i], tvns[:, i + 1]
        h = (tr - tl) / substeps
        for j in range(substeps):
            t = tl + j * h

            def ctrl(a):
                a = a / substeps
                return ml + (mr - ml) * a, vl + (vr - vl) * a

            (m0, v0), (m1, v1), (m2, v2) = ctrl(j), ctrl(j + 0.5), ctrl(j + 1.0)
            hc = h[:, None]
            k1 = field(t, y, m0, v0, ctx, P, nn, arith)
            k2 = field(t + 0.5 * h, y + 0.5 * hc * k1, m1, v1, ctx, P, nn, arith)
            k3 = field(t + 0.5 * h, y + 0.5 * hc * k2, m1, v1, ctx, P, nn, arith)
            k4 = field(t + h, y + hc * k3, m2, v2, ctx, P, nn, arith)
            y = y + (hc / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        out.append(y)
    return torch.stack(out, dim=1)


def data_loss(preds, obs, mask, weights) -> torch.Tensor:
    """Masked, state-weighted mean squared error over all observed points."""
    se = (preds - obs) ** 2 * weights
    w = mask[..., None]
    return torch.sum(w * se) / (torch.sum(w) * obs.shape[-1] + 1e-8)


def l2(nn: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of squares of the MLP's weight matrices (biases not penalised)."""
    return sum(torch.sum(v * v) for k, v in nn.items() if k.startswith("w"))
