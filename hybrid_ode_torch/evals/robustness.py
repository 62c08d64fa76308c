"""Robustness evaluation: missing and noisy conditioning data.

Port of `hybrid_ode_tpu/evals/robustness.py`. Corruption hits the data the
model conditions on (each window's initial state and the context encoder's
observations); scoring is always against the uncorrupted observations over
the full horizon.

  * missingness p: each observation is dropped with probability p (zeroed
    for the encoder, its mask cleared; a dropped first point puts the
    initial state at the cohort mean, z = 0).
  * noise k sigma: the conditioning observations carry k times the
    measurement noise, i.e. an extra sqrt(k^2 - 1) sigma_obs per state.

The corruption draws are numpy's (`default_rng(seed + s)`), as in the JAX
package, so both packages corrupt the same points. A single model's rollout
is one `batched_forward` over the whole dataset (a `use_pallas` checkpoint:
one fused forward launch per sweep point); an ensemble is scored by its
member-mean rollout (member axis written out, no fused kernel).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import GlucoseDataset, batch_to_tensors
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.evals.metrics import compute_rmse
from hybrid_ode_torch.models.hybrid import HybridConfig, batched_forward, with_context

logger = logging.getLogger("hybrid_ode_torch.robustness")

#: default per-state observation-noise std in z-units for the 4GI cohort
#: (10% CV multiplicative noise)
DEFAULT_OBS_SIGMA_Z = 0.33

OBS_TRUTH_COLUMNS = [
    ("glucose_mmol_L", "glucose_true_mmol_L"),
    ("insulin_pmol_L", "insulin_true_pmol_L"),
    ("glucagon_pmol_L", "glucagon_true_pmol_L"),
    ("glp1_pmol_L", "glp1_true_pmol_L"),
]


@torch.no_grad()
def _predict(params, batch: Dict, config: HybridConfig, ensemble: bool = False) -> np.ndarray:
    """Full-horizon rollout conditioned on the (possibly corrupted) batch,
    on the device that holds `params`."""
    if ensemble:
        from hybrid_ode_torch.parallel.ensemble import ensemble_forward

        return ensemble_forward(params, batch, config).mean(dim=0).cpu().numpy()
    b = batch_to_tensors(batch, next(iter(params["ode"].values())).device)
    controls = Controls(ts=b["time_points"], signals=dict(b["external_inputs"]))
    controls = with_context(params, b, controls, config)
    return batched_forward(params, b["initial_state"], b["time_points"], controls,
                           config).cpu().numpy()


def _clean_batch(ds: GlucoseDataset) -> Dict:
    return ds.batch(np.arange(len(ds)))


def _score(preds: np.ndarray, ds: GlucoseDataset, state_index: int) -> float:
    """RMSE of one state in physical units against the clean observations."""
    rmse = compute_rmse(preds[..., state_index: state_index + 1],
                        ds.observations[..., state_index: state_index + 1], mask=ds.mask)
    return float(rmse * float(ds.state_std[state_index]))


def missing_data_sweep(
    params: Any,
    ds: GlucoseDataset,
    config: HybridConfig,
    fractions: Sequence[float] = (0.0, 0.1, 0.3, 0.5),
    seed: int = 0,
    state_index: int = 0,
    n_seeds: int = 1,
    ensemble: bool = False,
) -> Dict[float, float]:
    """RMSE when a fraction of the conditioning observations is missing,
    averaged over `n_seeds` corruption draws ({fraction: RMSE})."""
    out = {}
    for frac in fractions:
        vals = []
        for s in range(max(1, n_seeds)):
            rng = np.random.default_rng(seed + s)
            batch = _clean_batch(ds)
            if frac > 0:
                keep = rng.uniform(size=ds.mask.shape) >= frac  # (N, T)
                obs_c = np.where(keep[..., None], batch["observations"], 0.0)
                init_c = np.where(keep[:, :1], batch["initial_state"], 0.0)
                batch = dict(batch, observations=obs_c.astype(np.float32),
                             initial_state=init_c.astype(np.float32),
                             mask=(batch["mask"] * keep).astype(np.float32))
            vals.append(_score(_predict(params, batch, config, ensemble), ds, state_index))
            if frac == 0:
                break  # no randomness in the clean row
        out[frac] = float(np.mean(vals))
        logger.info("missing %.0f%%: glucose RMSE %.3f", frac * 100, out[frac])
    return out


def noise_sweep(
    params: Any,
    ds: GlucoseDataset,
    config: HybridConfig,
    noise_multipliers: Sequence[float] = (1.0, 2.0),
    obs_sigma_z: Optional[np.ndarray] = None,
    seed: int = 0,
    state_index: int = 0,
    n_seeds: int = 1,
    ensemble: bool = False,
) -> Dict[float, float]:
    """RMSE when the conditioning observations carry k times the measurement
    noise ({k: RMSE}; k=1 is the unmodified dataset)."""
    sigma = np.asarray(obs_sigma_z if obs_sigma_z is not None else DEFAULT_OBS_SIGMA_Z,
                       np.float32)
    out = {}
    for k in noise_multipliers:
        vals = []
        for s in range(max(1, n_seeds)):
            rng = np.random.default_rng(seed + s)
            batch = _clean_batch(ds)
            if k > 1.0:
                extra = np.sqrt(k ** 2 - 1.0) * sigma
                noise = (extra * rng.standard_normal(
                    np.shape(batch["observations"]))).astype(np.float32)
                obs_c = batch["observations"] + noise * ds.mask[..., None]
                batch = dict(batch, observations=obs_c,
                             initial_state=obs_c[:, 0].astype(np.float32))
            vals.append(_score(_predict(params, batch, config, ensemble), ds, state_index))
            if k <= 1.0:
                break
        out[k] = float(np.mean(vals))
        logger.info("noise %gx: glucose RMSE %.3f", k, out[k])
    return out


def estimate_obs_sigma_z(ds: GlucoseDataset, truth: Mapping[str, np.ndarray]) -> np.ndarray:
    """Per-state observation-noise std in z-units from a column table with
    observed and noiseless truth columns (as `data/mimic.py` returns or
    `data.dataset.read_parquet_columns` reads); states without both are 0."""
    sig = np.zeros(6, np.float32)
    for i, (obs_c, true_c) in enumerate(OBS_TRUTH_COLUMNS):
        if obs_c in truth and true_c in truth:
            resid = np.asarray(truth[obs_c]) - np.asarray(truth[true_c])
            sig[i] = resid.std() / max(float(ds.state_std[i]), 1e-12)
    return sig


def robustness_report(
    params: Any, ds: GlucoseDataset, config: HybridConfig, out_path: str = None,
    obs_sigma_z: Optional[np.ndarray] = None, n_seeds: int = 1, ensemble: bool = False,
) -> Dict[str, Dict[float, float]]:
    """Both sweeps ({'missing_data': ..., 'conditioning_noise': ...}),
    written as JSON to `out_path` when given. ensemble=True: `params` is
    member-stacked and the member-mean rollout is scored."""
    report = {
        "missing_data": missing_data_sweep(params, ds, config, n_seeds=n_seeds,
                                           ensemble=ensemble),
        "conditioning_noise": noise_sweep(params, ds, config, noise_multipliers=(1.0, 2.0),
                                          obs_sigma_z=obs_sigma_z, n_seeds=n_seeds,
                                          ensemble=ensemble),
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump({k: {str(kk): vv for kk, vv in v.items()} for k, v in report.items()},
                      f, indent=2)
    return report
