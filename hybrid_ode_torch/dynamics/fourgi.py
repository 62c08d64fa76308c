"""8-state "4GI" integrated glucose–insulin–GLP-1–glucagon–GIP simulator field.

Port of `hybrid_ode_tpu/dynamics/fourgi.py`, the ground-truth generator's
field. It is a plain function of tensors, batched over leading axes: states
(..., 8), and parameters that are 0-d or carry the same leading axes
(per-subject values), so a whole cohort is one batched solve
(`hybrid_ode_torch/data/fourgi_gen.py`).

State layout (last axis, size 8):
    0: Gc    central glucose amount (mmol)
    1: Ins   insulin amount (pmol)
    2: GLP   GLP-1 amount (pmol)
    3: Glg   glucagon amount (pmol)
    4: GIP   GIP amount (pmol)
    5: Gp    peripheral glucose amount (mmol)
    6: InsE  insulin effect compartment (pmol/L)
    7: GIPp  peripheral GIP amount (pmol)
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import torch

from hybrid_ode_torch.utils.device import resolve_device

# Structural parameters of the 4GI model (its paper's Tables 3-4). The T2DM
# and healthy-volunteer variants differ in glucose clearance and in the
# hypoglycaemic glucagon-feedback exponent.
_COMMON = {
    "Qglc": 26.5,
    "VCglc": 9.33,
    "VPglc": 8.56,
    "CLins": 73.2,
    "VCins": 6.09,
    "Ke0ins": math.exp(-0.159),
    "VCglp": 16.0,
    "VM_GLP": math.exp(7.97),
    "KM_GLP": math.exp(4.91),
    "CLglg": 453.2,
    "VCglg": 64.6,
    "CLgip": 86.8,
    "VCgip": 9.21,
    "Qgip": 49.4,
    "VPgip": 22.8,
    "GLCINS_S": 2.46,
    "EMAX_1": math.exp(2.37),
    "EC50_1": math.exp(3.29),
    "HILL_1": 1.79,
    "EMAX_4": 6.73,
    "EC50_4": math.exp(4.59),
    "FDGLP": 0.0102,
    "FDGIP": 0.0343,
    "FDGLG": 0.00329,
    # baselines (concentrations)
    "BSLglc": 7.0,
    "BSLins": 50.0,
    "BSLglp": 10.0,
    "BSLglg": 25.0,
    "BSLgip": 20.0,
}

FOURGI_PARAMS_T2DM: Dict[str, float] = dict(
    _COMMON, CLglc=1.72, CLglci=0.0256, POW2_high=0.925, POW2_low=0.0
)
FOURGI_PARAMS_HV: Dict[str, float] = dict(
    _COMMON, CLglc=5.36, CLglci=0.072, POW2_high=0.925, POW2_low=0.327
)


def fourgi_params(patient_type: str = "T2DM", dtype: torch.dtype = torch.float32,
                  device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """The variant's parameters as 0-d tensors on `device` (CUDA unless the
    caller asks for the CPU; raises without CUDA)."""
    dev = resolve_device(device)
    base = FOURGI_PARAMS_T2DM if patient_type.upper() == "T2DM" else FOURGI_PARAMS_HV
    return {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in base.items()}


def fourgi_initial_state(p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Baseline initial amounts (..., 8); per-subject baselines give one row
    per subject."""
    cols = [
        p["BSLglc"] * p["VCglc"],
        p["BSLins"] * p["VCins"],
        p["BSLglp"] * p["VCglp"],
        p["BSLglg"] * p["VCglg"],
        p["BSLgip"] * p["VCgip"],
        p["BSLglc"] * p["VPglc"],
        p["BSLins"] * torch.ones_like(p["BSLins"]),
        p["BSLgip"] * p["VPgip"],
    ]
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def fourgi_field(t, y: torch.Tensor, params: Mapping[str, torch.Tensor],
                 inputs: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """4GI vector field of states (..., 8); the meal enters as
    inputs['meal_rate'] (mmol glucose / h), broadcast against y[..., 0].

    Branch-free: the regime-switching glucagon-feedback exponent and the
    meal-gated incretin food effects are `torch.where`s. The optional
    inputs['secretion_scale'] (< 1: beta-cell failure) multiplies the
    endogenous insulin production term only."""
    del t  # autonomous; forcing enters through `inputs`
    p = params
    Gc, Ins, GLP, Glg, GIP, Gp, InsE, GIPp = (y[..., i] for i in range(8))

    zeros = torch.zeros_like(Gc)
    inputs = inputs or {}
    meal_rate = inputs.get("meal_rate", zeros)

    Cglc = Gc / p["VCglc"]
    Cins = Ins / p["VCins"]
    Cglp = GLP / p["VCglp"]
    Cglg = Glg / p["VCglg"]

    # GLP-1 effect on insulin secretion (Hill)
    glp_ratio = (Cglp / p["EC50_1"]) ** p["HILL_1"]
    GLPINS_S = p["EMAX_1"] * glp_ratio / (1.0 + glp_ratio)
    glp0_ratio = (p["BSLglp"] / p["EC50_1"]) ** p["HILL_1"]
    GLPINS_S0 = p["EMAX_1"] * glp0_ratio / (1.0 + glp0_ratio)

    # glucagon effect on glucose production (Emax)
    GLGGLC_S = p["EMAX_4"] * (Cglg / p["EC50_4"]) / (1.0 + Cglg / p["EC50_4"])
    GLGGLC_S0 = p["EMAX_4"] * (p["BSLglg"] / p["EC50_4"]) / (1.0 + p["BSLglg"] / p["EC50_4"])
    glgEFFglc = (1.0 + GLGGLC_S) / (1.0 + GLGGLC_S0)

    # glucose feedback on glucagon with a regime-switching exponent
    POW_2 = torch.where(Cglc >= p["BSLglc"], p["POW2_high"], p["POW2_low"])
    safe_Cglc = torch.clamp(Cglc, min=1e-6)
    glcEFFglg = torch.where(Cglc > 0, (p["BSLglc"] / safe_Cglc) ** POW_2,
                            torch.ones_like(Cglc))

    # baseline production rates; KINglp's VCglp factor is the generator's
    # own (the JAX package keeps it too: tests/test_dynamics.py)
    KINglc = p["BSLglc"] * (p["CLglc"] + p["CLglci"] * p["BSLins"])
    KINins = p["BSLins"] * p["CLins"] / (1.0 + GLPINS_S0 * p["BSLglc"] ** p["GLCINS_S"])
    KINglp = p["VM_GLP"] * p["BSLglp"] * p["VCglp"] / (p["KM_GLP"] + p["BSLglp"])
    KINglg = p["BSLglg"] * p["CLglg"]
    KINgip = p["BSLgip"] * p["CLgip"]

    # food effects (the generator amplifies the meal by 10x)
    meal_effect = meal_rate * 10.0
    gate = (meal_effect > 0).to(y.dtype)
    FDGLP_S = p["FDGLP"] * meal_effect * gate
    FDGIP_S = p["FDGIP"] * meal_effect * gate
    FDGLG_S = p["FDGLG"] * meal_effect * gate

    K27 = p["Qglc"] / p["VCglc"]
    K72 = p["Qglc"] / p["VPglc"]
    dGc = (
        meal_rate
        + KINglc * glgEFFglc
        - K27 * Gc
        + K72 * Gp
        - (p["CLglc"] / p["VCglc"]) * Gc
        - (p["CLglci"] * InsE / p["VCglc"]) * Gc
    )
    sec_scale = inputs.get("secretion_scale")
    if sec_scale is None:
        sec_scale = 1.0
    dIns = sec_scale * KINins * (
        1.0 + GLPINS_S * safe_Cglc ** p["GLCINS_S"]
    ) - (p["CLins"] / p["VCins"]) * Ins
    dGLP = KINglp * (1.0 + FDGLP_S) - p["VM_GLP"] * Cglp / (p["KM_GLP"] + Cglp)
    dGlg = KINglg * (1.0 + FDGLG_S) * glcEFFglg - (p["CLglg"] / p["VCglg"]) * Glg
    K612 = p["Qgip"] / p["VCgip"]
    K126 = p["Qgip"] / p["VPgip"]
    dGIP = KINgip * (1.0 + FDGIP_S) - (p["CLgip"] / p["VCgip"]) * GIP - K612 * GIP + K126 * GIPp
    dGp = K27 * Gc - K72 * Gp
    dInsE = p["Ke0ins"] * (Cins - InsE)
    dGIPp = K612 * GIP - K126 * GIPp

    return torch.stack([dGc, dIns, dGLP, dGlg, dGIP, dGp, dInsE, dGIPp], dim=-1)


def fourgi_concentrations(y: torch.Tensor, p: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Amount states -> the measured concentrations (...,)."""
    return {
        "glucose": y[..., 0] / p["VCglc"],
        "insulin": y[..., 1] / p["VCins"],
        "glp1": y[..., 2] / p["VCglp"],
        "glucagon": y[..., 3] / p["VCglg"],
        "gip": y[..., 4] / p["VCgip"],
    }
