"""Model evaluation of a point checkpoint over a test set.

Port of `hybrid_ode_tpu/evals/evaluate.py`, point path: the forward pass
runs on the device that holds the parameters (the fused RK4 kernel when the
config says `use_pallas`), metrics in numpy on the host. The ensemble, VI
and identification estimators are not ported yet and raise.

    python -m hybrid_ode_torch.evals.evaluate checkpoints/accuracy_benchmark/best_model
"""

from __future__ import annotations

import csv
import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import GlucoseDataset, batch_iterator, batch_to_tensors, pad_batch
from hybrid_ode_torch.evals.metrics import (
    STATE_NAMES,
    compute_calibration_error,
    compute_coverage,
    compute_crps,
    compute_mae,
    compute_nll,
    compute_r2,
    compute_rmse,
)
from hybrid_ode_torch.models.hybrid import (
    HybridConfig,
    batched_forward,
    config_from_dict,
    controls_from_batch,
    with_context,
)

logger = logging.getLogger("hybrid_ode_torch.eval")


def _device_of(params: Any) -> torch.device:
    return params["nn"]["w0"].device


@torch.no_grad()
def _predict(params: Any, batch: Dict, config: HybridConfig) -> np.ndarray:
    """Point forward pass of one (padded) batch -> (B, T, 6) on the host."""
    b = batch_to_tensors(batch, _device_of(params))
    controls = with_context(params, b, controls_from_batch(b), config)
    preds = batched_forward(params, b["initial_state"], b["time_points"], controls, config)
    return preds.cpu().numpy()


def fit_observation_noise(params: Any, val_ds: GlucoseDataset, config: HybridConfig,
                          batch_size: int = 32) -> np.ndarray:
    """Per-state predictive noise sigma (6,): the masked RMS residual of the
    point forward pass on a validation split."""
    num = np.zeros(6)
    den = np.zeros(6)
    for batch in batch_iterator(val_ds, batch_size, shuffle=False):
        b, valid = pad_batch(batch, batch_size)
        nb = int(valid.sum())
        preds = _predict(params, b, config)[:nb]
        targ = np.asarray(b["observations"])[:nb]
        w = np.asarray(b.get("mask_channels", b["mask"]))[:nb]
        if w.ndim == 2:
            w = w[..., None] * np.ones_like(preds)
        num += ((preds - targ) ** 2 * w).sum(axis=(0, 1))
        den += w.sum(axis=(0, 1))
    return np.sqrt(np.maximum(num / np.maximum(den, 1.0), 1e-8))


def evaluate_model(
    params: Any,
    test_ds: GlucoseDataset,
    config: HybridConfig,
    batch_size: int = 32,
    variational=None,
    ensemble: bool = False,
    val_ds: Optional[GlucoseDataset] = None,
    identify_steps: int = 0,
    identify_params_steps: int = 0,
) -> Dict[str, float]:
    """Point-checkpoint metrics on a dataset, on the device holding `params`.

    With `val_ds` the predictive noise is moment-matched per state on it
    (`fit_observation_noise`) and the calibration metrics are reported;
    without it the reference's fixed sigma=0.1 placeholder is used and
    calibration columns are left out."""
    if variational is not None:
        raise NotImplementedError("VI posterior-predictive evaluation is not ported "
                                  "yet: ROADMAP Queue A 13 (Bayesian inference)")
    if ensemble:
        raise NotImplementedError("ensemble evaluation is not ported yet: ROADMAP "
                                  "Queue A 11 (ensembles)")
    if identify_steps or identify_params_steps:
        raise NotImplementedError("test-time identification at evaluation runs for "
                                  "ensembles only, which are not ported yet: ROADMAP "
                                  "Queue A 11 (ensembles)")
    point_sigma = None
    if val_ds is not None:
        point_sigma = fit_observation_noise(params, val_ds, config, batch_size)

    preds_all, targ_all, mask_all = [], [], []
    for batch in batch_iterator(test_ds, batch_size, shuffle=False):
        b, valid = pad_batch(batch, batch_size)
        nb = int(valid.sum())
        preds_all.append(_predict(params, b, config)[:nb])
        targ_all.append(np.asarray(b["observations"])[:nb])
        mask_all.append(np.asarray(b.get("mask_channels", b["mask"]))[:nb])

    preds = np.concatenate(preds_all)
    targets = np.concatenate(targ_all)
    mask = np.concatenate(mask_all)
    sigma = point_sigma if point_sigma is not None else 0.1
    unc = np.broadcast_to(np.asarray(sigma, preds.dtype), preds.shape)

    metrics: Dict[str, float] = {}
    metrics["rmse"] = compute_rmse(preds, targets, mask=mask)
    metrics["mae"] = compute_mae(preds, targets, mask=mask)
    metrics["r2"] = compute_r2(preds, targets, mask=mask)
    rmse_ps = compute_rmse(preds, targets, per_state=True, mask=mask)
    mae_ps = compute_mae(preds, targets, per_state=True, mask=mask)
    for i, name in enumerate(STATE_NAMES):
        metrics[f"rmse_{name.lower()}"] = float(rmse_ps[i])
        metrics[f"mae_{name.lower()}"] = float(mae_ps[i])

    if point_sigma is not None:
        metrics.update(compute_calibration_error(preds, unc, targets, mask=mask))
        metrics["coverage_80"] = compute_coverage(preds, unc, targets, 0.8, mask=mask)
        metrics["coverage_90"] = compute_coverage(preds, unc, targets, 0.9, mask=mask)
        metrics["nll"] = compute_nll(preds, unc, targets, mask=mask)
        metrics["crps"] = compute_crps(preds, unc, targets, mask=mask)
        for i, name in enumerate(STATE_NAMES):
            metrics[f"noise_sigma_{name.lower()}"] = float(point_sigma[i])

    m = mask[..., None] if mask.ndim < targets.ndim else mask
    m = np.broadcast_to(m.astype(bool), targets.shape)
    target_std = np.array([targets[..., i][m[..., i]].std() for i in range(targets.shape[-1])])
    metrics["nrmse"] = float(metrics["rmse"] / max(np.mean(target_std), 1e-12))
    for i, name in enumerate(STATE_NAMES):
        metrics[f"nrmse_{name.lower()}"] = float(rmse_ps[i] / max(target_std[i], 1e-12))
    return metrics


def evaluate_checkpoint(
    checkpoint_path: str,
    test_ds: GlucoseDataset,
    config: Optional[HybridConfig] = None,
    batch_size: int = 32,
    val_ds: Optional[GlucoseDataset] = None,
    use_pallas: Optional[bool] = None,
    device="cuda",
    **eval_kw,
) -> Dict[str, float]:
    """Rebuild the model from a checkpoint's embedded config and evaluate it
    on `device`. `use_pallas` overrides the config's kernel switch (the
    checkpoint metadata may not carry one)."""
    from hybrid_ode_torch.utils.checkpoint import load_checkpoint
    from hybrid_ode_torch.utils.convert import params_from_numpy

    state, meta = load_checkpoint(checkpoint_path)
    if meta.get("n_members", 0):
        raise NotImplementedError("ensemble checkpoints are not ported yet: ROADMAP "
                                  "Queue A 11 (ensembles)")
    params = params_from_numpy(state["params"], device=device)
    if config is None:
        config = config_from_dict(meta.get("config", {}))
    if use_pallas is not None:
        config = dataclasses.replace(config, use_pallas=use_pallas)
    metrics = evaluate_model(params, test_ds, config, batch_size, val_ds=val_ds, **eval_kw)
    metrics["checkpoint_epoch"] = meta.get("epoch", -1)
    val_loss = meta.get("val_loss")
    metrics["checkpoint_val_loss"] = -1 if val_loss is None else val_loss
    return metrics


def save_evaluation_results(metrics: Dict[str, float], output_path: str) -> None:
    """One-row CSV plus a formatted text summary beside it."""
    with open(output_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(metrics))
        writer.writeheader()
        writer.writerow(metrics)
    with open(Path(output_path).with_suffix(".txt"), "w") as f:
        f.write("Model Evaluation Results\n" + "=" * 50 + "\n\n")
        f.write("Overall Metrics:\n")
        f.write(f"  RMSE: {metrics['rmse']:.4f}\n")
        f.write(f"  MAE: {metrics['mae']:.4f}\n")
        f.write(f"  Normalized RMSE: {metrics['nrmse']:.4f}\n\n")
        f.write("Per-State RMSE:\n")
        for state in STATE_NAMES:
            k = f"rmse_{state.lower()}"
            if k in metrics:
                f.write(f"  {state}: {metrics[k]:.4f}\n")
        f.write("\n")
        if "ece" in metrics:
            f.write("Calibration Metrics:\n")
            f.write(f"  Expected Calibration Error: {metrics['ece']:.4f}\n")
            f.write(f"  95% Coverage: {metrics['coverage_95']:.4f}\n")
            f.write(f"  Sharpness: {metrics['sharpness']:.4f}\n")
            f.write(f"  MSIS: {metrics['msis']:.4f}\n")
    logger.info("evaluation results saved to %s", output_path)


def main(argv=None) -> None:
    import argparse

    from hybrid_ode_torch.data.dataset import create_data_arrays, split_dataset

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Evaluate a trained checkpoint (PyTorch port)")
    ap.add_argument("checkpoint", type=str)
    ap.add_argument("--data", type=str, default="data/4gi_dataset.csv")
    ap.add_argument("--output", type=str, default="evaluation_results.csv")
    ap.add_argument("--sequence-length", type=int, default=61)
    ap.add_argument("--stride", type=int, default=30)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=None,
                    help="override the checkpoint's fused-kernel switch")
    ap.add_argument("--norm-from", type=str, default=None,
                    help="normalize --data with THIS file's statistics")
    ap.add_argument("--no-split", action="store_true",
                    help="evaluate every window of --data instead of the seed-42 test split")
    args = ap.parse_args(argv)

    norm_stats = None
    if args.norm_from:
        ref_ds = create_data_arrays(args.norm_from, args.sequence_length, args.stride)
        norm_stats = (ref_ds.state_mean, ref_ds.state_std)
    ds = create_data_arrays(args.data, args.sequence_length, args.stride, norm_stats=norm_stats)
    if args.no_split:
        val_ds, test_ds = None, ds
    else:
        _, val_ds, test_ds = split_dataset(ds, seed=42)
    metrics = evaluate_checkpoint(args.checkpoint, test_ds, val_ds=val_ds,
                                  use_pallas=args.use_pallas, device=args.device)
    save_evaluation_results(metrics, args.output)
    print(f"RMSE: {metrics['rmse']:.4f}  MAE: {metrics['mae']:.4f}  NRMSE: {metrics['nrmse']:.4f}")


if __name__ == "__main__":
    main()
