"""Model evaluation of a checkpoint (a point model or an ensemble) over a test set.

Port of `hybrid_ode_tpu/evals/evaluate.py`, point and ensemble paths: the
forward pass runs on the device that holds the parameters (the fused RK4
kernel when a point model's config says `use_pallas`), metrics in numpy on
the host. Ensemble checkpoints (member-stacked leaves) are scored by the
ensemble mean and the members' spread, optionally after per-member
test-time identification of the subject codes (the identified ensemble).
A VI checkpoint (`--vi-checkpoint`) is scored by its posterior predictive.

    python -m hybrid_ode_torch.evals.evaluate checkpoints/accuracy_benchmark/best_model
    python -m hybrid_ode_torch.evals.evaluate checkpoints/ensemble_id/ensemble_model \
        --identify-steps 150 --identify-points 36 --vs-truth
    python -m hybrid_ode_torch.evals.evaluate - --vi-checkpoint <dir>/vi_model \
        --posterior-samples 100
"""

from __future__ import annotations

import csv
import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import (
    GlucoseDataset,
    batch_iterator,
    batch_to_tensors,
    pad_batch,
    read_columns,
)
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
    return next(iter(params["ode"].values())).device


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
    n_posterior_samples: int = 100,
    generator: Optional[torch.Generator] = None,
    denormalize: bool = False,
    obs_sigma=0.0,
    ensemble: bool = False,
    val_ds: Optional[GlucoseDataset] = None,
    identify_steps: int = 0,
    identify_points: Optional[int] = None,
    identify_params_steps: int = 0,
    identify_param_prior: float = 0.2,
    encoder=None,
    return_arrays: bool = False,
):
    """Metrics on a dataset, on the device holding `params`.

    Point models: with `val_ds` the predictive noise is moment-matched per
    state on it (`fit_observation_noise`) and the calibration metrics are
    reported; without it the reference's fixed sigma=0.1 placeholder is used
    and calibration columns are left out.

    ensemble: `params` is member-stacked; predictions are the ensemble mean,
    the uncertainty the members' spread (+ `obs_sigma` in quadrature), and
    the calibration metrics are reported. `identify_steps` > 0 (ensembles of
    context-conditioned models only) refines each member's subject codes on
    the window's first `identify_points` observations (default the model's
    context_points) before the rollout, from the amortised `encoder`'s codes
    when one is given; `identify_params_steps` > 0 then also refines
    per-window multipliers on all mechanistic parameters (trust region
    `identify_param_prior`). `denormalize` reports in physical units;
    `return_arrays` also returns (preds, unc, targets, mask).

    variational (a `VariationalInference`): predictions are the posterior
    predictive mean over `n_posterior_samples` samples, the uncertainty its
    spread and `obs_sigma` in quadrature; each batch draws from its own
    generator split from `generator` (a CPU generator seeded 0 if none),
    and the calibration metrics are reported."""
    if ensemble:
        from hybrid_ode_torch.parallel.ensemble import (
            ensemble_predictive,
            identified_ensemble_predictive,
        )
    elif identify_steps:
        raise ValueError("identify_steps requires ensemble=True "
                         "(stacked-params checkpoints)")
    if variational is not None and generator is None:
        generator = torch.Generator().manual_seed(0)
    point_sigma = None
    if val_ds is not None and variational is None and not ensemble:
        point_sigma = fit_observation_noise(params, val_ds, config, batch_size)

    preds_all, unc_all, targ_all, mask_all = [], [], [], []
    for batch in batch_iterator(test_ds, batch_size, shuffle=False):
        b, valid = pad_batch(batch, batch_size)
        nb = int(valid.sum())
        if ensemble:
            sigma = obs_sigma if np.any(np.asarray(obs_sigma) > 0) else None
            if identify_steps:
                preds, unc = identified_ensemble_predictive(
                    params, b, config, id_steps=identify_steps, points=identify_points,
                    encoder=encoder, noise_sigma=sigma,
                    refine_params=identify_params_steps > 0,
                    param_steps=identify_params_steps or 150,
                    param_prior_std=identify_param_prior)
            else:
                preds, unc = ensemble_predictive(params, b, config, noise_sigma=sigma)
            preds, unc = preds.cpu().numpy(), unc.cpu().numpy()
        elif variational is not None:
            from hybrid_ode_torch.inference.vi import split_generator

            bt = batch_to_tensors(b, variational.device)
            with torch.no_grad():
                controls = with_context(variational.template, bt, controls_from_batch(bt),
                                        config)
            mean, std = variational.posterior_predictive(
                split_generator(generator), bt["initial_state"], bt["time_points"], controls,
                n_samples=n_posterior_samples)
            # parameter uncertainty and observation noise in quadrature
            sig = torch.as_tensor(np.asarray(obs_sigma), dtype=std.dtype, device=std.device)
            preds, unc = mean.cpu().numpy(), torch.sqrt(std ** 2 + sig ** 2).cpu().numpy()
        else:
            preds = _predict(params, b, config)
            sigma = point_sigma if point_sigma is not None else 0.1
            unc = np.broadcast_to(np.asarray(sigma, preds.dtype), preds.shape)
        preds_all.append(preds[:nb])
        unc_all.append(unc[:nb])
        targ_all.append(np.asarray(b["observations"])[:nb])
        mask_all.append(np.asarray(b.get("mask_channels", b["mask"]))[:nb])

    preds = np.concatenate(preds_all)
    unc = np.concatenate(unc_all)
    targets = np.concatenate(targ_all)
    mask = np.concatenate(mask_all)
    if denormalize:
        preds = preds * test_ds.state_std + test_ds.state_mean
        targets = targets * test_ds.state_std + test_ds.state_mean
        unc = unc * test_ds.state_std

    metrics: Dict[str, float] = {}
    metrics["rmse"] = compute_rmse(preds, targets, mask=mask)
    metrics["mae"] = compute_mae(preds, targets, mask=mask)
    metrics["r2"] = compute_r2(preds, targets, mask=mask)
    rmse_ps = compute_rmse(preds, targets, per_state=True, mask=mask)
    mae_ps = compute_mae(preds, targets, per_state=True, mask=mask)
    for i, name in enumerate(STATE_NAMES):
        metrics[f"rmse_{name.lower()}"] = float(rmse_ps[i])
        metrics[f"mae_{name.lower()}"] = float(mae_ps[i])

    if variational is not None or ensemble or point_sigma is not None:
        metrics.update(compute_calibration_error(preds, unc, targets, mask=mask))
        metrics["coverage_80"] = compute_coverage(preds, unc, targets, 0.8, mask=mask)
        metrics["coverage_90"] = compute_coverage(preds, unc, targets, 0.9, mask=mask)
        metrics["nll"] = compute_nll(preds, unc, targets, mask=mask)
        metrics["crps"] = compute_crps(preds, unc, targets, mask=mask)
    if point_sigma is not None:
        for i, name in enumerate(STATE_NAMES):
            metrics[f"noise_sigma_{name.lower()}"] = float(point_sigma[i])

    m = mask[..., None] if mask.ndim < targets.ndim else mask
    m = np.broadcast_to(m.astype(bool), targets.shape)
    target_std = np.array([targets[..., i][m[..., i]].std() for i in range(targets.shape[-1])])
    metrics["nrmse"] = float(metrics["rmse"] / max(np.mean(target_std), 1e-12))
    for i, name in enumerate(STATE_NAMES):
        metrics[f"nrmse_{name.lower()}"] = float(rmse_ps[i] / max(target_std[i], 1e-12))
    if return_arrays:
        return metrics, (preds, unc, targets, mask)
    return metrics


def glucose_truth_rmse(preds: np.ndarray, test_ds: GlucoseDataset, data_path: str) -> float:
    """Physical-units glucose RMSE against the generator's noiseless truth
    column `glucose_true_mmol_L` of `data_path` (a CSV read with the `csv`
    module, or a Parquet file read through pyarrow). preds: (N_windows, T,
    n) in the dataset's normalised coordinates, in dataset order; each
    window's truth is taken at the nearest file time of its subject. The time
    column is the first of time_hours / time_h / time, as in the JAX package
    (a file with time_minutes alone has none, and raises there too)."""
    header, col, keys = read_columns(data_path)
    if "glucose_true_mmol_L" not in header:
        raise ValueError(f"{data_path} has no glucose_true_mmol_L column")
    tcol = next(c for c in ("time_hours", "time_h", "time") if c in header)
    t_all = np.asarray(col(tcol), dtype=np.float64)
    g_all = np.asarray(col("glucose_true_mmol_L"), dtype=np.float64)
    by_subj = {}
    for sid in set(keys.tolist()):
        rows = np.nonzero(keys == sid)[0]
        by_subj[sid] = (t_all[rows], g_all[rows])
    g_pred = preds[..., 0] * float(test_ds.state_std[0]) + float(test_ds.state_mean[0])
    se, cnt = 0.0, 0
    for w in range(len(test_ds)):
        t_file, g_true = by_subj[test_ds.subject_ids[w]]
        idx = np.abs(t_file[None, :] - test_ds.time_points[w][:, None]).argmin(1)
        se += float(((g_pred[w] - g_true[idx]) ** 2).sum())
        cnt += len(idx)
    return float(np.sqrt(se / max(cnt, 1)))


def evaluate_checkpoint(
    checkpoint_path: str,
    test_ds: GlucoseDataset,
    config: Optional[HybridConfig] = None,
    batch_size: int = 32,
    val_ds: Optional[GlucoseDataset] = None,
    use_pallas: Optional[bool] = None,
    device="cuda",
    **eval_kw,
):
    """Rebuild the model from a checkpoint's embedded config and evaluate it
    on `device`. `use_pallas` overrides a point model's kernel switch (the
    checkpoint metadata may not carry one). A member-stacked checkpoint
    (metadata `n_members`) is evaluated as an ensemble, never through the
    fused kernels; its `checkpoint_val_loss` is the mean of the members'
    `best_val` where it records no `val_loss`. `eval_kw` goes to
    `evaluate_model` (`identify_steps=`, `return_arrays=`, ...)."""
    from hybrid_ode_torch.utils.checkpoint import load_checkpoint
    from hybrid_ode_torch.utils.convert import params_from_numpy

    state, meta = load_checkpoint(checkpoint_path)
    is_ensemble = bool(meta.get("n_members", 0))
    # ensemble checkpoints store the stacked params tree itself
    params = params_from_numpy(state if is_ensemble else state["params"], device=device)
    if config is None:
        config = config_from_dict(meta.get("config", {}),
                                  **({"use_pallas": False} if is_ensemble else {}))
    if use_pallas is not None and not is_ensemble:
        config = dataclasses.replace(config, use_pallas=use_pallas)
    out = evaluate_model(params, test_ds, config, batch_size, ensemble=is_ensemble,
                         val_ds=val_ds, **eval_kw)
    metrics, arrays = out if eval_kw.get("return_arrays") else (out, None)
    metrics["checkpoint_epoch"] = meta.get("epoch", -1)
    val_loss = meta.get("val_loss")
    if val_loss is None and meta.get("best_val"):
        val_loss = float(np.mean(meta["best_val"]))
    metrics["checkpoint_val_loss"] = -1 if val_loss is None else val_loss
    return (metrics, arrays) if arrays is not None else metrics


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
    ap.add_argument("--identify-steps", type=int, default=0,
                    help="ensemble checkpoints: per-member test-time identification steps "
                         "before the rollout (the identified ensemble)")
    ap.add_argument("--identify-points", type=int, default=None,
                    help="identification-window length (observations); default the "
                         "model's context_points")
    ap.add_argument("--identify-params-steps", type=int, default=0,
                    help="also refine per-window log-scale multipliers on all mechanistic "
                         "parameters for this many steps after the codes")
    ap.add_argument("--identify-param-prior", type=float, default=0.2,
                    help="trust-region width of those multipliers")
    ap.add_argument("--vs-truth", action="store_true",
                    help="also report physical glucose RMSE against the file's noiseless "
                         "glucose_true_mmol_L column")
    ap.add_argument("--vi-checkpoint", type=str, default=None,
                    help="VI checkpoint dir: evaluate the variational posterior predictive "
                         "(calibration metrics included)")
    ap.add_argument("--posterior-samples", type=int, default=100)
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
    if args.vi_checkpoint:
        from hybrid_ode_torch.inference.vi import VariationalInference

        vi = VariationalInference.restore(args.vi_checkpoint, device=args.device)
        out = evaluate_model(vi.template, test_ds, vi.config, variational=vi,
                             n_posterior_samples=args.posterior_samples,
                             obs_sigma=vi.noise_sigma, return_arrays=args.vs_truth)
    else:
        out = evaluate_checkpoint(args.checkpoint, test_ds, val_ds=val_ds,
                                  use_pallas=args.use_pallas, device=args.device,
                                  identify_steps=args.identify_steps,
                                  identify_points=args.identify_points,
                                  identify_params_steps=args.identify_params_steps,
                                  identify_param_prior=args.identify_param_prior,
                                  return_arrays=args.vs_truth)
    if args.vs_truth:
        metrics, (preds, _, _, _) = out
        metrics["glucose_rmse_vs_truth_mmol"] = glucose_truth_rmse(preds, test_ds, args.data)
    else:
        metrics = out
    save_evaluation_results(metrics, args.output)
    print(f"RMSE: {metrics['rmse']:.4f}  MAE: {metrics['mae']:.4f}  NRMSE: {metrics['nrmse']:.4f}"
          + (f"  glucose-vs-truth: {metrics['glucose_rmse_vs_truth_mmol']:.4f} mmol/L"
             if "glucose_rmse_vs_truth_mmol" in metrics else ""))


if __name__ == "__main__":
    main()
