"""Metrics, checkpoint evaluation, robustness sweeps and latent recovery."""

from hybrid_ode_torch.evals.metrics import (
    compute_rmse,
    compute_mae,
    compute_r2,
    compute_calibration_error,
    compute_coverage,
    compute_nll,
    compute_crps,
)
from hybrid_ode_torch.evals.evaluate import (
    evaluate_model,
    evaluate_checkpoint,
    save_evaluation_results,
)
from hybrid_ode_torch.evals.robustness import missing_data_sweep, noise_sweep, robustness_report
from hybrid_ode_torch.evals.latent import dtw_distance, latent_recovery_metrics

__all__ = [
    "compute_rmse",
    "compute_mae",
    "compute_r2",
    "compute_calibration_error",
    "compute_coverage",
    "compute_nll",
    "compute_crps",
    "evaluate_model",
    "evaluate_checkpoint",
    "save_evaluation_results",
    "missing_data_sweep",
    "noise_sweep",
    "robustness_report",
    "dtw_distance",
    "latent_recovery_metrics",
]
