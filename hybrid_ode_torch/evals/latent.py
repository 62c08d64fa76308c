"""Latent-trajectory recovery metrics: R^2, Pearson rho, and DTW distance.

Copy of `hybrid_ode_tpu/evals/latent.py` (numpy on the host). Use-case: hide
the GLP-1 channel from the model at fit time and score how well the
rolled-out GLP-1 state tracks the held-out (or simulator-truth) GLP-1 signal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Classic O(T^2) dynamic-time-warping distance with |.| local cost."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        cost_row = np.abs(a[i - 1] - b)
        for j in range(1, m + 1):
            D[i, j] = cost_row[j - 1] + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])


def latent_recovery_metrics(predicted: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    """R^2, Pearson rho, DTW between predicted and true latent trajectories.

    predicted/truth: (..., T) — metrics computed on the flattened pairs, DTW
    averaged over leading axes.
    """
    p = np.asarray(predicted, np.float64)
    t = np.asarray(truth, np.float64)
    pf, tf = p.reshape(-1), t.reshape(-1)

    ss_res = np.sum((tf - pf) ** 2)
    ss_tot = np.sum((tf - tf.mean()) ** 2)
    r2 = float(1.0 - ss_res / max(ss_tot, 1e-12))

    pc = np.corrcoef(pf, tf)[0, 1] if pf.std() > 0 and tf.std() > 0 else float("nan")

    if p.ndim == 1:
        dtw = dtw_distance(p, t)
    else:
        p2 = p.reshape(-1, p.shape[-1])
        t2 = t.reshape(-1, t.shape[-1])
        dtw = float(np.mean([dtw_distance(p2[i], t2[i]) for i in range(p2.shape[0])]))

    # scale-free companions: R²/DTW after standardising predicted and true
    # trajectories separately (shape recovery irrespective of amplitude).
    # Needed because the 6-state model family's GLP-1 scale (V_max/k_L ≈ 250
    # pmol/L at Table-I values) cannot represent the 4GI generator's
    # 3000-pmol/L truth — the manuscript's DTW is itself in "a.u.".
    def std_(x):
        s = x.std()
        return (x - x.mean()) / (s if s > 0 else 1.0)

    ps, ts_ = std_(pf), std_(tf)
    r2_std = float(1.0 - np.sum((ts_ - ps) ** 2) / max(np.sum(ts_**2), 1e-12))
    if p.ndim == 1:
        dtw_std = dtw_distance(std_(p), std_(t))
    else:
        dtw_std = float(np.mean([
            dtw_distance(std_(p2[i]), std_(t2[i])) for i in range(p2.shape[0])
        ]))

    return {"r2": r2, "pearson": float(pc), "dtw": dtw,
            "r2_standardized": r2_std, "dtw_standardized": dtw_std}
