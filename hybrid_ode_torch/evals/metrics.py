"""Evaluation metrics: accuracy and uncertainty calibration (numpy).

Copy of what `hybrid_ode_tpu/evals/evaluate.py::evaluate_model` calls from
`hybrid_ode_tpu/evals/metrics.py`: RMSE / MAE / R², calibration (ECE, MSIS,
sharpness, 95% coverage), central-interval coverage, Gaussian NLL and
closed-form CRPS; and the post-hoc recalibration fits of the predictive
spread (`fit_uncertainty_scale`, `fit_per_state_recalibration`). Every
metric takes an optional observation mask, (B, T) per time point or
(B, T, C) per channel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
from scipy.special import erf, erfinv

STATE_NAMES = ("Glucose", "Insulin", "Glucagon", "GLP1", "GE", "FFA")


def _mask_flat(x: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if mask is None:
        return x.reshape(-1)
    m = np.asarray(mask, bool)
    if m.ndim < x.ndim:
        m = m[..., None]
    m = np.broadcast_to(m, x.shape)
    return x[m]


def _per_state(fn, p: np.ndarray, t: np.ndarray, mask) -> np.ndarray:
    out = np.zeros(p.shape[-1])
    for i in range(p.shape[-1]):
        mi = mask if (mask is None or np.asarray(mask).ndim < p.ndim) \
            else np.asarray(mask)[..., i: i + 1]
        pi = _mask_flat(p[..., i: i + 1], mi)
        ti = _mask_flat(t[..., i: i + 1], mi)
        out[i] = fn(pi, ti) if pi.size else np.nan
    return out


def compute_rmse(predictions: np.ndarray, targets: np.ndarray, per_state: bool = False,
                 mask: Optional[np.ndarray] = None) -> Union[float, np.ndarray]:
    p = np.asarray(predictions, np.float64)
    t = np.asarray(targets, np.float64)
    rmse = lambda a, b: math.sqrt(np.mean((a - b) ** 2))  # noqa: E731
    if per_state:
        return _per_state(rmse, p, t, mask)
    return float(rmse(_mask_flat(p, mask), _mask_flat(t, mask)))


def compute_mae(predictions: np.ndarray, targets: np.ndarray, per_state: bool = False,
                mask: Optional[np.ndarray] = None) -> Union[float, np.ndarray]:
    p = np.asarray(predictions, np.float64)
    t = np.asarray(targets, np.float64)
    mae = lambda a, b: np.mean(np.abs(a - b))  # noqa: E731
    if per_state:
        return _per_state(mae, p, t, mask)
    return float(mae(_mask_flat(p, mask), _mask_flat(t, mask)))


def compute_r2(predictions: np.ndarray, targets: np.ndarray,
               mask: Optional[np.ndarray] = None) -> float:
    pf, tf = _mask_flat(predictions, mask), _mask_flat(targets, mask)
    ss_res = np.sum((tf - pf) ** 2)
    ss_tot = np.sum((tf - tf.mean()) ** 2)
    return float(1.0 - ss_res / max(ss_tot, 1e-12))


def compute_calibration_error(predictions: np.ndarray, uncertainties: np.ndarray,
                              targets: np.ndarray, n_bins: int = 10,
                              mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """ECE (exact Gaussian |z| quantiles) + MSIS + sharpness + 95% coverage."""
    pf = _mask_flat(predictions, mask)
    uf = _mask_flat(uncertainties, mask)
    tf = _mask_flat(targets, mask)

    normalized = np.abs(pf - tf) / (uf + 1e-6)
    confs = np.linspace(0.0, 1.0, n_bins + 1)[:-1]
    observed = [float(np.mean(normalized <= math.sqrt(2.0) * erfinv(c))) for c in confs]
    ece = float(np.mean(np.abs(confs - np.array(observed))))

    alpha, z = 0.05, 1.96
    lower, upper = pf - z * uf, pf + z * uf
    penalty = (2.0 / alpha) * ((tf < lower) * (lower - tf) + (tf > upper) * (tf - upper))
    return {
        "ece": ece,
        "msis": float(np.mean(upper - lower + penalty)),
        "sharpness": float(np.mean(uf)),
        "coverage_95": float(np.mean((tf >= lower) & (tf <= upper))),
        "mean_normalized_error": float(np.mean(normalized)),
    }


def compute_coverage(predictions: np.ndarray, uncertainties: np.ndarray, targets: np.ndarray,
                     level: float = 0.9, mask: Optional[np.ndarray] = None) -> float:
    """Central-interval coverage at `level`."""
    pf = _mask_flat(predictions, mask)
    uf = _mask_flat(uncertainties, mask)
    tf = _mask_flat(targets, mask)
    return float(np.mean(np.abs(tf - pf) <= math.sqrt(2.0) * erfinv(level) * uf))


def compute_nll(predictions: np.ndarray, uncertainties: np.ndarray, targets: np.ndarray,
                mask: Optional[np.ndarray] = None) -> float:
    """Mean Gaussian negative log-likelihood."""
    pf = _mask_flat(predictions, mask)
    uf = np.maximum(_mask_flat(uncertainties, mask), 1e-6)
    tf = _mask_flat(targets, mask)
    return float(np.mean(0.5 * np.log(2 * np.pi * uf**2) + 0.5 * ((tf - pf) / uf) ** 2))


def compute_crps(predictions: np.ndarray, uncertainties: np.ndarray, targets: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> float:
    """Closed-form CRPS for Gaussian predictive distributions."""
    pf = _mask_flat(predictions, mask)
    uf = np.maximum(_mask_flat(uncertainties, mask), 1e-6)
    tf = _mask_flat(targets, mask)
    z = (tf - pf) / uf
    phi = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    Phi = 0.5 * (1 + erf(z / math.sqrt(2)))
    return float(np.mean(uf * (z * (2 * Phi - 1) + 2 * phi - 1 / math.sqrt(math.pi))))


def fit_uncertainty_scale(predictions: np.ndarray, uncertainties: np.ndarray,
                          targets: np.ndarray, mask: Optional[np.ndarray] = None,
                          scales: Optional[np.ndarray] = None) -> float:
    """The scalar s (from `scales`, default 201 log-spaced in [0.1, 10])
    whose s * uncertainties has the lowest ECE: post-hoc variance
    recalibration, fit on a validation split and applied on test."""
    if scales is None:
        scales = np.logspace(-1.0, 1.0, 201)
    best_s, best_e = 1.0, np.inf
    for s in scales:
        e = compute_calibration_error(predictions, s * uncertainties, targets, mask=mask)["ece"]
        if e < best_e:
            best_s, best_e = float(s), float(e)
    return best_s


def fit_per_state_recalibration(predictions: np.ndarray, uncertainties: np.ndarray,
                                targets: np.ndarray, mask: Optional[np.ndarray] = None,
                                min_coverage_95: float = 0.95) -> np.ndarray:
    """Per-state variance recalibration with a coverage floor: for each state
    channel the scale (251 log-spaced in [10^-1.5, 10]) of lowest ECE among
    those that keep its 95% coverage >= `min_coverage_95`, else the widest.
    Returns (C,) scales to multiply the uncertainty array by."""
    p = np.asarray(predictions, np.float64)
    u = np.asarray(uncertainties, np.float64)
    t = np.asarray(targets, np.float64)
    C = p.shape[-1]
    scales = np.logspace(-1.5, 1.0, 251)
    out = np.ones(C)
    for i in range(C):
        mi = mask
        if mask is not None and np.asarray(mask).ndim == p.ndim:
            mi = np.asarray(mask)[..., i: i + 1]
        pi, ui, ti = p[..., i: i + 1], u[..., i: i + 1], t[..., i: i + 1]
        if _mask_flat(pi, mi).size == 0:
            continue
        best_s, best_e = None, np.inf
        for s in scales:
            m = compute_calibration_error(pi, s * ui, ti, mask=mi)
            if m["coverage_95"] >= min_coverage_95 and m["ece"] < best_e:
                best_s, best_e = float(s), float(m["ece"])
        out[i] = float(scales[-1]) if best_s is None else best_s
    return out
