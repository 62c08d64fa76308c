"""Closed-loop insulin protocols on the hybrid model, and their optimisation.

Port of `hybrid_ode_tpu/models/protocol.py`. The model rolls an ICU
sliding-scale protocol forward in closed loop: every `check_every` grid steps
the infusion rate is recomputed from the model's own predicted glucose by the
ICU generator's law (`data/mimic.py`),

    rate = clip(basal + gain (G - target), 0, cap) / rate_scale,

and the protocol parameters are optimised by gradients through the rollout
(Adam). The JAX package scans the chunks; here they are a Python loop, one
`batched_forward` per chunk. A single model with `use_pallas` (rk4,
`exog_insulin='nn'`) runs each chunk through the fused forward kernel; the
ensembles write the member axis out (`parallel/ensemble.py`), each member
running its own loop, so its insulin signal is its own (K, B, T).

Causal use needs a causal insulin routing (`exog_insulin='mech'` or
'mech_blind' checkpoints); the fused path refuses those, so protocol
gradients run on the plain solvers.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import batch_to_tensors
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models.hybrid import (
    HybridConfig,
    batched_forward,
    controls_from_batch,
    with_context,
)


def _device(params: Mapping[str, Any]) -> torch.device:
    return next(iter(params["ode"].values())).device


def _rollout(params, y0, ts, meal, ctx, config, gain, target, norm, check_every, rate_cap,
             rate_scale, basal, glucose_offset, expand) -> Dict[str, torch.Tensor]:
    """The closed loop on states y0 (..., B, 6) and grids ts (..., B, T);
    `expand` maps a (B, ...) batch input to the leading axes."""
    B, T = ts.shape[-2:]
    C = (T - 1) // check_every
    if C * check_every != T - 1:
        raise ValueError(f"T-1={T - 1} grid intervals not divisible by check_every={check_every}")
    dt = y0.dtype
    mean0 = torch.as_tensor(norm[0][0], dtype=dt, device=y0.device)
    std0 = torch.as_tensor(norm[1][0], dtype=dt, device=y0.device)
    off = (torch.zeros((B, T), dtype=dt, device=y0.device) if glucose_offset is None
           else torch.as_tensor(glucose_offset, dtype=dt, device=y0.device))

    def protocol(g_mmol):
        rate = torch.clamp(basal + gain * (g_mmol - target), 0.0, rate_cap)
        return rate / rate_scale  # the tVNS channel's export scale

    y = y0
    rate = protocol(y0[..., 0] * std0 + mean0 + off[:, 0])
    chunks, rates = [y0[..., None, :]], []
    for c in range(C):
        sl = slice(c * check_every, (c + 1) * check_every + 1)
        ts_k = ts[..., sl]
        signals = {"meal": expand(meal[:, sl]),
                   "tVNS": rate[..., None].expand(ts_k.shape)}
        if ctx is not None:
            signals["context"] = ctx
        traj = batched_forward(params, y, ts_k, Controls(ts=ts_k, signals=signals), config)
        y = traj[..., -1, :]
        chunks.append(traj[..., 1:, :])
        rates.append(rate)
        rate = protocol(y[..., 0] * std0 + mean0 + off[:, (c + 1) * check_every])
    trajectory = torch.cat(chunks, dim=-2)
    rates = torch.stack(rates, dim=-1) * rate_scale  # (..., B, C) pmol/h
    dt_h = ts[..., 0, 1] - ts[..., 0, 0]
    return {
        "trajectory": trajectory,
        "glucose": trajectory[..., 0] * std0 + mean0,
        "rates": rates,
        "insulin_total": rates.sum(dim=-1) * dt_h[..., None] * check_every,
    }


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def closed_loop_rollout(
    params: Mapping[str, Any],
    batch: Mapping[str, Any],
    config: HybridConfig,
    gain,
    target,
    norm: Tuple[Any, Any],
    check_every: int = 12,
    rate_cap: float = 7000.0,
    rate_scale: float = 2000.0,
    basal=0.0,
    glucose_offset=None,
) -> Dict[str, torch.Tensor]:
    """Roll one hybrid model forward under a closed-loop sliding scale.

    batch: one window per patient over the design horizon ('initial_state'
    (B, 6) z-space, 'time_points' (B, T) hours on a uniform grid, the 'meal'
    schedule; a 'tVNS' input is ignored: the protocol makes it). gain
    (pmol/h per mmol/L), target (mmol/L) and basal (pmol/h) are scalars or
    (B,) tensors, differentiable. norm: the training cohort's (mean, std) of
    the states (z -> mmol/L for the law). check_every grid steps between
    nurse checks (T-1 must be a multiple). glucose_offset: optional (B, T)
    mmol/L added to the predicted glucose before the law reads it (bias
    anchoring to measured glucose). The subject context is encoded once
    from the batch. Returns 'trajectory' (B, T, 6), 'glucose' (B, T) mmol/L,
    'rates' (B, C) pmol/h, 'insulin_total' (B,) pmol."""
    b = batch_to_tensors(batch, _device(params))
    y0, ts = b["initial_state"], b["time_points"]
    meal = (b.get("external_inputs") or {}).get("meal", torch.zeros_like(ts))
    ctx = None
    if config.context_points > 0:
        ctx = with_context(params, b, controls_from_batch(b), config).signals["context"]
    return _rollout(params, y0, ts, meal, ctx, config, _as(gain, y0), _as(target, y0), norm,
                    check_every, rate_cap, rate_scale, _as(basal, y0), glucose_offset,
                    lambda x: x)


def ensemble_closed_loop(
    stacked_params: Mapping[str, Any],
    batch: Mapping[str, Any],
    config: HybridConfig,
    gain,
    target,
    norm: Tuple[Any, Any],
    check_every: int = 12,
    rate_cap: float = 7000.0,
    rate_scale: float = 2000.0,
    basal=0.0,
    glucose_offset=None,
) -> Dict[str, torch.Tensor]:
    """Per-member closed-loop rollouts (a leading K on every output): each
    member runs its own loop, the protocol reacting to that member's
    predicted glucose, so the K rollouts sample the policy's outcome under
    model uncertainty. The member axis is written out (one batched solve per
    chunk for all members; no fused kernel); arguments as
    `closed_loop_rollout`."""
    from hybrid_ode_torch.parallel.ensemble import (
        _member_codes,
        _member_view,
        _members,
        _n_members,
        _no_pallas,
    )

    cfg = _no_pallas(config)
    b = batch_to_tensors(batch, _device(stacked_params))
    K = _n_members(stacked_params)
    y0, ts = b["initial_state"], b["time_points"]
    meal = (b.get("external_inputs") or {}).get("meal", torch.zeros_like(ts))
    ctx = None
    if cfg.context_points > 0 and "enc" in stacked_params:
        ctx = _member_codes(stacked_params["enc"], b["observations"], ts,
                            cfg.context_points, cfg.activation)
    return _rollout(_member_view(stacked_params, 1), _members(y0, K), _members(ts, K), meal,
                    ctx, cfg, _as(gain, y0), _as(target, y0), norm, check_every, rate_cap,
                    rate_scale, _as(basal, y0), glucose_offset, lambda x: _members(x, K))


def glycemic_risk(glucose_mmol: torch.Tensor, hypo: float = 3.9, hyper: float = 10.0,
                  hypo_weight: float = 25.0) -> torch.Tensor:
    """Asymmetric out-of-range risk, the mean over all axes: quadratic
    excursions outside [hypo, hyper] mmol/L, hypoglycaemia weighted
    `hypo_weight` times."""
    zero = torch.zeros((), dtype=glucose_mmol.dtype, device=glucose_mmol.device)
    low = torch.maximum(hypo - glucose_mmol, zero)
    high = torch.maximum(glucose_mmol - hyper, zero)
    return torch.mean(hypo_weight * low ** 2 + high ** 2)


def cvar_glycemic_risk(glucose_mmol: torch.Tensor, alpha: float = 0.25, **risk_kw) -> torch.Tensor:
    """CVaR_alpha of the per-member risk (glucose (K, ...)): the mean of the
    worst ceil(alpha K) members' `glycemic_risk`."""
    K = glucose_mmol.shape[0]
    per_member = torch.stack([glycemic_risk(g, **risk_kw) for g in glucose_mmol])
    k_tail = max(1, int(np.ceil(alpha * K)))
    return torch.sort(per_member).values[K - k_tail:].mean()


def time_in_range(glucose_mmol: torch.Tensor, lo: float = 3.9, hi: float = 10.0) -> torch.Tensor:
    """Fraction of time in [lo, hi] mmol/L."""
    g = torch.as_tensor(glucose_mmol)
    return ((g >= lo) & (g <= hi)).to(g.dtype if g.is_floating_point() else torch.float32).mean()


def counterfactual_delta_correction(pred_arm, pred_factual, observed_factual):
    """observed_factual + (pred_arm - pred_factual): the model's policy delta
    anchored to the trajectory observed under the deployed protocol (a
    leading ensemble axis of the predictions broadcasts)."""
    return observed_factual + (pred_arm - pred_factual)


def robust_delta_risk(pred_arm, pred_factual, observed_factual,
                      lambdas: Tuple[float, ...] = (0.5, 1.0, 2.0),
                      objective: Callable[[torch.Tensor], torch.Tensor] = glycemic_risk
                      ) -> torch.Tensor:
    """max over lambda of objective(observed + lambda (pred_arm -
    pred_factual)): the worst case under dose-response scale uncertainty (an
    optimisation objective, not a ranking metric)."""
    delta = pred_arm - pred_factual
    return torch.amax(torch.stack([objective(observed_factual + lam * delta)
                                   for lam in lambdas]))


def optimize_protocol(
    rollout: Callable[..., torch.Tensor],
    init_gain=900.0,
    init_target=7.0,
    objective: Callable[[torch.Tensor], torch.Tensor] = glycemic_risk,
    steps: int = 150,
    lr: float = 0.05,
    target_bounds: Tuple[float, float] = (4.5, 9.0),
    gain_bounds: Optional[Tuple[float, float]] = None,
    init_basal=None,
    basal_bounds: Tuple[float, float] = (0.0, 15000.0),
    device=None,
) -> Dict[str, Any]:
    """Gradient-optimise (gain, target[, basal]) through a model rollout.

    rollout(gain, target[, basal]) -> predicted glucose (mmol/L); scalars
    optimise one population protocol, (B,) initial values a per-patient one.
    The target (and the gain with `gain_bounds`, the basal with `init_basal`)
    lives in a sigmoid box, the unbounded gain in log space; Adam with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8) at `lr`. `device`: where
    the protocol parameters live (default: the card). Returns 'gain',
    'target' (floats, or numpy for per-patient), 'basal' with `init_basal`,
    'risk' (the objective at each step's parameters before its update, then
    at the final ones: steps + 1 values), 'init_risk', 'final_risk'."""
    from hybrid_ode_torch.utils.device import resolve_device

    dev = resolve_device("cuda" if device is None else device)

    def box(val, bounds):
        lo, hi = bounds
        x0 = torch.clamp((torch.as_tensor(val, dtype=torch.float32) - lo) / (hi - lo),
                         1e-3, 1 - 1e-3)
        return torch.log(x0 / (1 - x0)).to(dev)

    def unbox(logit, bounds):
        lo, hi = bounds
        return lo + (hi - lo) * torch.sigmoid(logit)

    z = {"logit_target": box(init_target, target_bounds)}
    if gain_bounds is None:
        z["log_gain"] = torch.log(torch.as_tensor(init_gain, dtype=torch.float32)).to(dev)
    else:
        z["logit_gain"] = box(init_gain, gain_bounds)
    if init_basal is not None:
        z["logit_basal"] = box(init_basal, basal_bounds)
    for v in z.values():
        v.requires_grad_(True)

    def unpack():
        gain = torch.exp(z["log_gain"]) if gain_bounds is None else unbox(z["logit_gain"],
                                                                          gain_bounds)
        out = (gain, unbox(z["logit_target"], target_bounds))
        return out if init_basal is None else out + (unbox(z["logit_basal"], basal_bounds),)

    opt = torch.optim.Adam(list(z.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    trace = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        val = objective(rollout(*unpack()))
        val.backward()
        trace.append(float(val.detach()))  # the risk at the pre-update parameters
        opt.step()
    with torch.no_grad():
        trace.append(float(objective(rollout(*unpack()))))
        unpacked = unpack()

    def to_py(x):
        return float(x) if x.ndim == 0 else x.cpu().numpy()

    out = {"gain": to_py(unpacked[0]), "target": to_py(unpacked[1]), "risk": trace,
           "init_risk": trace[0], "final_risk": trace[-1]}
    if init_basal is not None:
        out["basal"] = to_py(unpacked[2])
    return out


def _scaled(stacked: Mapping[str, Any], s: torch.Tensor) -> Dict[str, Any]:
    """The stacked params with ode.k_ex multiplied by s."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in stacked.items()}
    out["ode"]["k_ex"] = out["ode"]["k_ex"] * s
    return out


@torch.no_grad()
def calibrate_dose_response(
    stacked_params: Mapping[str, Any],
    batch: Mapping[str, Any],
    config: HybridConfig,
    norm: Tuple[Any, Any],
    gain_w,
    target_w,
    basal_w,
    observed_glucose,
    observed_mask,
    subject_idx: np.ndarray,
    reference_protocol: Tuple[float, float, float] = (900.0, 7.0, 0.0),
    scales: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
    rate_cap: float = 20000.0,
    check_every: int = 12,
    instruments: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """The exogenous-insulin response scale identified from the training
    cohort's randomised per-patient protocols, and the k_ex-calibrated
    ensemble.

    For each scale s (k_ex <- s k_ex): m_p(s) is the ensemble's predicted
    effect of patient p's own protocol against `reference_protocol`
    (anchored closed-loop rollouts, charting-time masked mean glucose, windows
    averaged per patient), and slope(s) = cov(y_p, m_p) / var(m_p) with y_p
    the patient's observed masked mean glucose; with `instruments` (P, d)
    the slope is 2SLS on their projection (+ intercept). s* is the
    linear-regime estimate slope(1) (the smallest scanned scale when that
    slope is not positive). Returns 'scale', 'slope_at_scale', 'slopes'
    (per scale: slope, r2, effect_sd_mmol[, first_stage_r2]; non-finite as
    None), 'n_patients' and 'stacked_calibrated'."""
    dev = _device(stacked_params)
    dt = next(iter(stacked_params["ode"].values())).dtype

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    g_ref, t_ref, b_ref = (t(x) for x in reference_protocol)
    mask, obs = t(observed_mask), t(observed_glucose)
    gain_w, target_w, basal_w = t(gain_w), t(target_w), t(basal_w)
    B = obs.shape[0]
    P = int(subject_idx.max()) + 1
    win_per_p = np.zeros(P)
    np.add.at(win_per_p, subject_idx, np.ones(B))

    def per_patient(vals_w):
        acc = np.zeros(P)
        np.add.at(acc, subject_idx, np.asarray(vals_w))
        return acc / np.maximum(win_per_p, 1.0)

    def masked_mean_t(g):  # (..., B, T) -> (..., B)
        return (g * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)

    y_p = per_patient(masked_mean_t(obs).cpu().numpy())

    def effects(s):
        ps = _scaled(stacked_params, t(float(s)))

        def roll(gain, target, basal, off):
            return ensemble_closed_loop(ps, batch, config, gain, target, norm, basal=basal,
                                        glucose_offset=off, rate_cap=rate_cap,
                                        check_every=check_every)["glucose"]

        g_own0 = roll(gain_w, target_w, basal_w, torch.zeros_like(obs))
        anchor = obs - torch.mean(g_own0, dim=0)
        g_own = roll(gain_w, target_w, basal_w, anchor)
        g_rf = roll(g_ref, t_ref, b_ref, anchor)
        return masked_mean_t(torch.mean(g_own, 0) - torch.mean(g_rf, 0)).cpu().numpy()

    Z = None
    if instruments is not None:
        zr = np.asarray(instruments, np.float64)
        zr = (zr - zr.mean(0)) / np.maximum(zr.std(0), 1e-12)
        Z = np.concatenate([np.ones((P, 1)), zr], axis=1)

    def fin(x, nd):
        return round(float(x), nd) if np.isfinite(x) else None

    slopes, details = {}, {}
    for s in scales:
        m_p = per_patient(effects(s))
        mc = m_p - m_p.mean()
        yc = y_p - y_p.mean()
        extra = {}
        if Z is not None:
            coef, *_ = np.linalg.lstsq(Z, mc, rcond=None)
            m_hat = Z @ coef
            var_mh = float((m_hat * m_hat).mean())
            slope = float((m_hat * yc).mean() / max(var_mh, 1e-12))
            extra["first_stage_r2"] = round(var_mh / max(float((mc * mc).mean()), 1e-12), 4)
            resid = yc - slope * m_hat
        else:
            var_m = float((mc * mc).mean())
            slope = float((mc * yc).mean() / max(var_m, 1e-12))
            resid = yc - slope * mc
        r2 = 1.0 - float((resid ** 2).mean()) / max(float((yc ** 2).mean()), 1e-12)
        slopes[float(s)] = slope
        details[float(s)] = {"slope": fin(slope, 4), "r2": fin(r2, 4),
                             "effect_sd_mmol": fin(m_p.std(), 4),
                             **{k: fin(v, 4) for k, v in extra.items()}}

    ss = np.array(sorted(slopes))
    sl = np.array([slopes[s] for s in ss])
    s1 = float(sl[0]) if np.isfinite(sl[0]) else 0.0
    s_star = float(ss[0]) if s1 <= 0.0 else s1
    near = float(ss[np.argmin(np.abs(np.log(ss) - math.log(max(s_star, 1e-9))))])
    return {
        "scale": s_star,
        "slope_at_scale": {"nearest_scanned_scale": near, "slope": details[near]["slope"]},
        "slopes": details,
        "n_patients": int(P),
        "stacked_calibrated": _scaled(stacked_params, t(s_star)),
    }
