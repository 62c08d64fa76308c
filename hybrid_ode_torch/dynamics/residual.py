"""MLP residual dynamics as plain functions of a parameter dict.

Port of `hybrid_ode_tpu/dynamics/residual.py`. Layout: flat dict
{'w0','b0',...,'w{n}','b{n}'} with w_i of shape (in, out), the JAX layout, so
weights carried across from a JAX checkpoint are used as they are.

    input  : [t, G, I, Glu, GLP1, GE, FFA, glp1_ext, tVNS] (+ extra features)
    hidden : n_layers x hidden_dim, activation (relu default)
    output : 6 residuals, zero-initialised (the hybrid starts as the pure ODE)
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from hybrid_ode_torch.utils.device import resolve_device

Activation = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
}


def init_mlp_params(
    generator: torch.Generator,
    input_dim: int = 9,
    hidden_dim: int = 64,
    output_dim: int = 6,
    n_layers: int = 4,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, torch.Tensor]:
    """Hidden layers Xavier-normal with gain 0.1, zero biases; output layer
    all zeros. Draws from `generator` (a CPU generator), then moves to
    `device` (CUDA unless the caller asks for the CPU; raises without CUDA)."""
    device = resolve_device(device)
    dims = [input_dim] + [hidden_dim] * n_layers + [output_dim]
    params: Dict[str, torch.Tensor] = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        if i == len(dims) - 2:
            w = torch.zeros((d_in, d_out), dtype=dtype)
        else:
            std = 0.1 * math.sqrt(2.0 / (d_in + d_out))
            w = std * torch.randn((d_in, d_out), generator=generator, dtype=dtype)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return params


def mlp_num_layers(params: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in params if k.startswith("w"))


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              activation: str = "relu", dropout: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply the MLP to features x of shape (..., input_dim).

    Member-stacked weights (w_i (K, in, out), b_i (K, out): a deep
    ensemble's) take x of shape (K, ..., input_dim); each member's rows go
    through its own weights as one batched product (K, N, in) x (K, in, out).

    dropout: hidden-layer dropout, active only with a `generator` (the
    training-mode semantics of torch's nn.Dropout): a unit is kept with
    probability 1 - dropout, from `generator`'s draws, and scaled by
    1 / (1 - dropout). The JAX package offers the same option, unused."""
    act = Activation[activation]
    n = mlp_num_layers(params)
    stacked = params["w0"].ndim == 3
    h = x.reshape(x.shape[0], -1, x.shape[-1]) if stacked else x
    for i in range(n):
        b = params[f"b{i}"]
        h = h @ params[f"w{i}"] + (b[:, None] if stacked else b)
        if i == n - 1:
            break
        h = act(h)
        if dropout > 0.0 and generator is not None:
            keep = torch.rand(h.shape, generator=generator, dtype=h.dtype,
                              device=generator.device).to(h.device) < 1.0 - dropout
            h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    return h.reshape(x.shape[:-1] + h.shape[-1:]) if stacked else h


def residual_features(t, y: torch.Tensor, glp1, tvns) -> torch.Tensor:
    """Assemble the 9-feature input [t, y(6), glp1, tVNS]."""
    lead = y.shape[:-1]

    def col(v):
        return torch.as_tensor(v, dtype=y.dtype, device=y.device).expand(lead)[..., None]

    return torch.cat([col(t), y, col(glp1), col(tvns)], dim=-1)


def residual_apply(
    params: Dict[str, torch.Tensor],
    t,
    y: torch.Tensor,
    glp1,
    tvns,
    activation: str = "relu",
    extra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NN residual g_NN(t, y, glp1, tVNS[, extra]) -> (..., 6).

    extra: optional additional features (..., d), broadcast against y's
    leading dims."""
    feats = residual_features(t, y, glp1, tvns)
    if extra is not None:
        extra = extra.expand(feats.shape[:-1] + extra.shape[-1:])
        feats = torch.cat([feats, extra], dim=-1)
    return mlp_apply(params, feats, activation)


def feature_importance(params: Dict[str, torch.Tensor], t, y: torch.Tensor, glp1, tvns,
                       activation: str = "relu") -> torch.Tensor:
    """Gradient-based feature importance: |d out_j / d in_i| of the residual
    MLP at the features of (t, y, glp1, tvns), averaged over the samples and
    the outputs -> (input_dim,)."""
    feats = residual_features(t, y, glp1, tvns)
    feats2d = feats.reshape(-1, feats.shape[-1]).detach()
    jac = torch.func.vmap(torch.func.jacrev(lambda f: mlp_apply(params, f, activation)))(feats2d)
    return torch.abs(jac).mean(dim=(0, 1))  # jac: (B, out, in)


def mlp_l2(params: Dict[str, torch.Tensor], l2_weight: float = 1e-4) -> torch.Tensor:
    """L2 penalty over weight matrices only (biases are not penalised)."""
    total = 0.0
    for k, v in params.items():
        if k.startswith("w"):
            total = total + torch.sum(v * v)
    return l2_weight * total
