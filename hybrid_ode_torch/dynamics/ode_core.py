"""Mechanistic 6-state glucose–insulin–glucagon–GLP-1–GE–FFA vector field.

Port of `hybrid_ode_tpu/dynamics/ode_core.py`: the field is a plain function
of `(t, y, params, inputs)` with parameters held in a dict of 0-d tensors.

State layout (last axis, size 6): G, I, Glu, GLP1, GE (dGE/dt = 0), FFA.

    Pi      = 1 + rho * GLP1
    dI/dt   = Pi * a_GI * (G - G_b) - k_I * (I - I_b)   [+ k_ex * I_ex]
    dGlu/dt = -E_max * GLP1 / (EC_50 + GLP1) * (Glu - Glu_b)
    dGLP1/dt= V_max * G / (K_m + G) - k_L * GLP1
    k_GE    = k_GE0 * (1 - GD^g / (IGD_50^g + GD^g))
    dFFA/dt = -p_7 * FFA - p_8 * I * FFA + p_9 * G * FFA
    dG/dt   = meal - S * (I - I_b) + 0.005 * (Glu - Glu_b) - k_GE * G
              with S = 0.01, or |S_I| when params carry a trainable S_I
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from hybrid_ode_torch.utils.device import resolve_device

DEFAULT_ODE_PARAMS: Dict[str, float] = {
    "a_GI": 0.0104,
    "k_I": 0.025,
    "rho": 0.003,
    "G_b": 5.0,
    "I_b": 60.0,
    "E_max": 0.1,
    "EC_50": 50.0,
    "Glu_b": 80.0,
    "V_max": 9.0,
    "K_m": 7.0,
    "k_L": 0.02,
    "k_GE0": 0.01,
    "IGD_50": 1000.0,
    "g": 2.0,
    "p_7": 0.05,
    "p_8": 0.001,
    "p_9": 0.01,
}

#: Parameters given variational/Bayesian treatment.
BAYES_ODE_PARAM_NAMES = ("a_GI", "k_I", "rho", "E_max", "EC_50", "V_max", "K_m", "k_L")


def make_ode_params(
    overrides: Optional[Mapping[str, float]] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, torch.Tensor]:
    """Parameter dict of 0-d tensors, user overrides merged onto defaults,
    on `device` (CUDA unless the caller asks for the CPU; raises without CUDA)."""
    device = resolve_device(device)
    params = dict(DEFAULT_ODE_PARAMS)
    if overrides:
        params.update({k: float(v) for k, v in overrides.items()})
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in params.items()}


def _safe_pow(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x**p for x >= 0 with a finite value and gradient at x == 0.

    A bare `x**p` has a NaN gradient at 0 (GD is often exactly 0); the
    double `where` keeps both the primal and the cotangent finite."""
    safe_x = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, safe_x ** p, torch.zeros_like(x))


def mechanistic_field(
    t,
    y: torch.Tensor,
    params: Mapping[str, torch.Tensor],
    inputs: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """dy/dt of the mechanistic core for states y of shape (..., 6).

    inputs: optional 'meal', 'GD' and 'I_ex' (broadcast against y[..., 0]).
    Parameters may be 0-d or carry leading batch dims (per-sample values)."""
    del t  # autonomous; forcing enters through `inputs`
    G = y[..., 0]
    I = y[..., 1]
    Glu = y[..., 2]
    GLP1 = y[..., 3]
    FFA = y[..., 5]

    zeros = torch.zeros_like(G)
    inputs = inputs or {}
    meal = inputs.get("meal", zeros)
    GD = inputs.get("GD", zeros)

    p = params
    Pi = 1.0 + p["rho"] * GLP1
    dI = Pi * p["a_GI"] * (G - p["G_b"]) - p["k_I"] * (I - p["I_b"])
    if "k_ex" in p:
        # exogenous insulin appearance through the learnable gain k_ex
        dI = dI + p["k_ex"] * inputs.get("I_ex", zeros)
    glp1_effect = p["E_max"] * GLP1 / (p["EC_50"] + GLP1)
    dGlu = -glp1_effect * (Glu - p["Glu_b"])
    dGLP1 = p["V_max"] * G / (p["K_m"] + G) - p["k_L"] * GLP1
    GD_pow = _safe_pow(GD, p["g"])
    k_GE = p["k_GE0"] * (1.0 - GD_pow / (_safe_pow(p["IGD_50"], p["g"]) + GD_pow))
    dFFA = -p["p_7"] * FFA - p["p_8"] * I * FFA + p["p_9"] * G * FFA
    # sign-definite trainable insulin sensitivity when present
    s_i = p.get("S_I")
    si_eff = 0.01 if s_i is None else torch.abs(s_i)
    dG = meal - si_eff * (I - p["I_b"]) + 0.005 * (Glu - p["Glu_b"]) - k_GE * G
    dGE = torch.zeros_like(G)
    return torch.stack([dG, dI, dGlu, dGLP1, dGE, dFFA], dim=-1)


def steady_state(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Approximate no-input steady state [G_b, I_b, Glu_b, 0, 0, 1]."""
    dev = params["G_b"].device
    basal = [params[k].to(torch.float32) for k in ("G_b", "I_b", "Glu_b")]
    rest = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (0.0, 0.0, 1.0)]
    return torch.stack(basal + rest)  # GLP1, GE, FFA (normalized)


def check_mass_balance(y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Physiological range checks of states (..., 6): every state >= 0,
    glucose in [2, 30], insulin in [0, 1000]; boolean tensors (...)."""
    G = y[..., 0]
    I = y[..., 1]
    return {
        "non_negative": torch.all(y >= 0, dim=-1),
        "glucose_range": (G >= 2.0) & (G <= 30.0),
        "insulin_range": (I >= 0.0) & (I <= 1000.0),
    }
