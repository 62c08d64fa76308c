"""The posterior that the NUTS cells sample, in plain PyTorch.

The 7 mechanistic parameters below are sampled; the rest of the model
(the other parameters, the MLP) is held at the checkpoint's values. Chain c
integrates every window of the batch with its own parameters (RK4, as
`model.rk4`). Columns of a position are the sampled names in sorted
order. Log density: Gaussian priors on the sampled values, plus a Gaussian
likelihood of every observed state with noise sigma:

    log p(q) = sum_k [-(q_k - mu_k)^2 / (2 sd_k^2) - log(2 pi sd_k^2) / 2]
             - sum_{b,t,s} m_bt (obs - pred)^2 / (2 sigma^2)
             - sum_{b,t} m_bt * 6 log(2 pi sigma^2) / 2
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference import model

PRIORS = {"a_GI": (0.0104, 0.002), "k_I": (0.025, 0.005), "rho": (0.003, 0.001),
          "E_max": (0.1, 0.02), "V_max": (9.0, 2.0), "K_m": (7.0, 1.5), "k_L": (0.02, 0.005)}
SAMPLED = tuple(sorted(PRIORS))


def log_density(Q: torch.Tensor, batch: Dict[str, torch.Tensor], P: Dict[str, torch.Tensor],
                nn: Dict[str, torch.Tensor], substeps: int, sigma: float = 1.0,
                arith=model.F32) -> torch.Tensor:
    """log p of positions Q (C, 7) -> (C,), given a batch of B windows."""
    C = Q.shape[0]
    y0, ts, meal, tvns = (batch[k] for k in ("initial_state", "time_points", "meal", "tvns"))
    obs, mask = batch["observations"], batch["mask"]
    B = y0.shape[0]
    Pc = dict(P)
    for i, name in enumerate(SAMPLED):
        Pc[name] = Q[:, i].repeat_interleave(B)
    preds = model.rk4(y0.repeat(C, 1), ts.repeat(C, 1), meal.repeat(C, 1), tvns.repeat(C, 1),
                      None, Pc, nn, substeps, arith).reshape((C,) + tuple(obs.shape))
    se = (obs - preds) ** 2 / sigma ** 2 * mask[..., None]
    like = -0.5 * se.sum(dim=(1, 2, 3)) - 0.5 * mask.sum() * 6 * math.log(2 * math.pi * sigma ** 2)
    prior = 0.0
    for i, name in enumerate(SAMPLED):
        mu, sd = PRIORS[name]
        prior = prior + (-0.5 * ((Q[:, i] - mu) / sd) ** 2 - 0.5 * math.log(2 * math.pi * sd ** 2))
    return prior + like


def log_density_and_grad(Q, batch, P, nn, substeps, sigma=1.0, arith=model.F32):
    """(log p (C,), its gradient (C, 7)); chains are independent."""
    with torch.enable_grad():
        Q = Q.detach().clone().requires_grad_(True)
        lp = log_density(Q, batch, P, nn, substeps, sigma, arith)
        (g,) = torch.autograd.grad(lp.sum(), Q)
    return lp.detach(), g
