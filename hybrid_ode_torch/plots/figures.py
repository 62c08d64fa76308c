"""Figures and tables of a checkpoint.

Port of `hybrid_ode_tpu/plots/figures.py`:

  Fig 1: predicted vs observed series (glucose, insulin, GLP-1) of the first
         windows, meal markers.
  Fig 2: Sobol sensitivity of [glucose AUC, insulin peak, GLP-1 response]
         over the Figure 2 parameter box (`plots/sobol.py`), the Saltelli rows
         in batched rk4 solves.
  Fig 3: posterior-predictive bands (95% interval and +-1 SD) of a VI
         posterior; Fig 1 without one.
  Tables: overall, per-state and model tables as CSV (the `csv` module, the
         JAX package's CSV text) and LaTeX (`DataFrame.to_latex`: pandas is
         imported for that alone).

matplotlib is imported when a figure is drawn (Agg backend), and pandas when
a LaTeX table is written; a missing library raises naming it. The model runs
on the device that holds its parameters.

    python -m hybrid_ode_torch.plots.figures --checkpoint checkpoints/accuracy_benchmark/best_model
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import GlucoseDataset, batch_to_tensors
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models.hybrid import HybridConfig, batched_forward, with_context
from hybrid_ode_torch.plots.sobol import DEFAULT_PROBLEM, sobol_sensitivity

logger = logging.getLogger("hybrid_ode_torch.plots")

_PLOT_STATES = [(0, "Glucose"), (1, "Insulin"), (3, "GLP-1")]


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing figures needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _device(params: Any) -> torch.device:
    return next(iter(params["ode"].values())).device


@torch.no_grad()
def plot_fig1_predictions(
    params: Any,
    ds: GlucoseDataset,
    config: HybridConfig,
    save_path: str = "results/figures/fig1_predictions.png",
    n_subjects: int = 3,
) -> str:
    """Predicted vs observed trajectories of the first n windows (one
    `batched_forward`: the fused kernel for a `use_pallas` model)."""
    plt = _plt()
    n = min(n_subjects, len(ds))
    batch = ds.batch(np.arange(n))
    b = batch_to_tensors(batch, _device(params))
    controls = Controls(ts=b["time_points"], signals=dict(b["external_inputs"]))
    controls = with_context(params, b, controls, config)
    preds = batched_forward(params, b["initial_state"], b["time_points"], controls,
                            config).cpu().numpy()

    fig, axes = plt.subplots(len(_PLOT_STATES), n, figsize=(5 * n, 9), squeeze=False)
    for col in range(n):
        t = batch["time_points"][col]
        meal_times = t[batch["external_inputs"]["meal"][col] > 0]
        for row, (sidx, name) in enumerate(_PLOT_STATES):
            ax = axes[row][col]
            ax.plot(t, batch["observations"][col, :, sidx], "k.", ms=4, label="observed")
            ax.plot(t, preds[col, :, sidx], "b-", lw=1.5, label="predicted")
            for mt in meal_times:
                ax.axvline(mt, color="r", ls="--", alpha=0.4)
            if row == 0:
                ax.set_title(f"Subject {col}")
            if col == 0:
                ax.set_ylabel(f"{name} (normalized)")
            if row == len(_PLOT_STATES) - 1:
                ax.set_xlabel("Time (hours)")
            if row == 0 and col == 0:
                ax.legend(fontsize=8)
    fig.suptitle("Hybrid ODE-NN predictions vs observations")
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    logger.info("fig1 saved to %s", save_path)
    return save_path


def make_fig2_simulator(params: Any, config: HybridConfig, outputs: str = "scalars"):
    """The fig2 sweep's simulation: initial state at basal values, a 75 mmol
    meal bolus at t=30 min, 5 h on 61 points, fixed-grid rk4 with 6 substeps
    (no fused kernel: the JAX package's sweep has none). simulate({name:
    (B,) tensor}) overrides those ODE parameters per row and returns (B, 3)
    [glucose AUC, insulin peak, GLP-1 response] (outputs='scalars') or the
    (B, 61) glucose trajectories ('glucose_t'). Context-conditioned models
    keep their input width and see the neutral zero context."""
    dev = _device(params)
    dtype = next(iter(params["ode"].values())).dtype
    ts = torch.linspace(0.0, 5.0, 61, dtype=torch.float32, device=dev).to(dtype)
    meal = torch.zeros(61, dtype=dtype, device=dev)
    meal[6] = 75.0
    y0 = torch.tensor([5.0, 60.0, 80.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
    sweep_cfg = HybridConfig(
        nn_hidden=config.nn_hidden, nn_layers=config.nn_layers,
        activation=config.activation, use_nn=config.use_nn,
        solver="rk4", substeps=6, mode="scan",
        context_points=config.context_points, context_dim=config.context_dim)

    def simulate(overrides: Dict[str, torch.Tensor]) -> torch.Tensor:
        B = next(iter(overrides.values())).shape[0]
        p = dict(params)
        p["ode"] = dict(params["ode"])
        for k, v in overrides.items():
            p["ode"][k] = v.to(device=dev, dtype=dtype)
        ts_b = ts.expand(B, 61)
        controls = Controls(ts=ts_b, signals={"meal": meal.expand(B, 61),
                                              "tVNS": torch.zeros_like(ts_b)})
        traj = batched_forward(p, y0.expand(B, 6), ts_b, controls, sweep_cfg)
        if outputs == "glucose_t":
            return traj[..., 0]
        auc = torch.trapezoid(traj[..., 0], dx=5.0 / 60.0, dim=-1)
        ipeak = torch.amax(traj[..., 1], dim=-1)
        glp1_resp = torch.mean(traj[:, 6:, 3], dim=-1)
        return torch.stack([auc, ipeak, glp1_resp], dim=-1)

    return simulate


def plot_fig2_sensitivity(
    params: Any,
    config: HybridConfig,
    save_path: str = "results/figures/fig2_sensitivity.png",
    n_samples: int = 1024,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Sobol sensitivity of [glucose AUC, insulin peak, GLP-1 response]
    (`make_fig2_simulator`), drawn as bars; returns the indices."""
    plt = _plt()
    simulate = make_fig2_simulator(params, config)
    res = sobol_sensitivity(simulate, DEFAULT_PROBLEM, n=n_samples, seed=seed,
                            device=_device(params))

    output_names = ["Glucose AUC", "Insulin Peak", "GLP-1 Response"]
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for j, out_name in enumerate(output_names):
        ax = axes[j]
        vals = res["S1"][:, j]
        ax.bar(res["names"], vals)
        ax.set_xlabel("Parameters")
        ax.set_ylabel("First-order Sobol Index")
        ax.set_title(f"Sensitivity: {out_name}")
        ax.set_xticks(range(len(res["names"])))
        ax.set_xticklabels(res["names"], rotation=45)
        for i, v in enumerate(vals):
            ax.text(i, v + 0.01, f"{v:.3f}", ha="center", fontsize=7)
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    logger.info("fig2 saved to %s", save_path)
    return res


@torch.no_grad()
def plot_fig3_posterior_bands(
    params: Any,
    ds: GlucoseDataset,
    config: HybridConfig,
    variational=None,
    save_path: str = "results/figures/fig3_posterior.png",
    n_samples: int = 100,
    generator: Optional[torch.Generator] = None,
) -> str:
    """Posterior predictive bands of a VI posterior (`inference/vi.py`) over
    the first 3 windows; Fig 1 without a posterior."""
    if variational is None:
        logger.warning("no variational posterior: falling back to fig1")
        return plot_fig1_predictions(params, ds, config, save_path)

    plt = _plt()
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    n = min(3, len(ds))
    batch = ds.batch(np.arange(n))
    b = batch_to_tensors(batch, variational.device)
    controls = Controls(ts=b["time_points"], signals=dict(b["external_inputs"]))
    mean, std = variational.posterior_predictive(generator, b["initial_state"],
                                                 b["time_points"], controls,
                                                 n_samples=n_samples)
    mean, std = mean.cpu().numpy(), std.cpu().numpy()

    fig, axes = plt.subplots(len(_PLOT_STATES), n, figsize=(5 * n, 9), squeeze=False)
    for col in range(n):
        t = batch["time_points"][col]
        for row, (sidx, name) in enumerate(_PLOT_STATES):
            ax = axes[row][col]
            m, s = mean[col, :, sidx], std[col, :, sidx]
            ax.fill_between(t, m - 1.96 * s, m + 1.96 * s, alpha=0.2, color="b", label="95% CI")
            ax.fill_between(t, m - s, m + s, alpha=0.3, color="b", label="±1 SD")
            ax.plot(t, m, "b-", lw=1.2, label="posterior mean")
            ax.plot(t, batch["observations"][col, :, sidx], "k.", ms=4, label="observed")
            if col == 0:
                ax.set_ylabel(f"{name} (normalized)")
            if row == len(_PLOT_STATES) - 1:
                ax.set_xlabel("Time (hours)")
            if row == 0 and col == 0:
                ax.legend(fontsize=7)
    fig.suptitle("Posterior predictive distribution (VI)")
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    logger.info("fig3 saved to %s", save_path)
    return save_path


def _cell(v) -> str:
    """A table cell as pandas' `to_csv` writes it: empty for a missing value,
    the shortest round-trip decimal for a float."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return ""
    return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)


def _write_table(rows, columns, out: Path, stem: str) -> None:
    with open(out / f"{stem}.csv", "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([[_cell(r[c]) for c in columns] for r in rows])
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"writing {stem}.tex needs pandas (DataFrame.to_latex), which is "
                          "not installed") from e
    df = pd.DataFrame(rows, columns=columns)
    (out / f"{stem}.tex").write_text(df.to_latex(index=False, float_format="%.4f", na_rep="-"))


def generate_performance_tables(metrics_by_model: Dict[str, Dict[str, float]],
                                out_dir: str = "results/tables") -> None:
    """Overall (table3_overall), per-state RMSE (table4_per_state) and the
    models of this run (table5_models), each as CSV and LaTeX."""
    from hybrid_ode_torch.evals.metrics import STATE_NAMES

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    overall = [{"Model": name, "RMSE": m.get("rmse"), "MAE": m.get("mae"),
                "NRMSE": m.get("nrmse"), "R2": m.get("r2"), "ECE": m.get("ece"),
                "Coverage95": m.get("coverage_95")} for name, m in metrics_by_model.items()]
    _write_table(overall, ["Model", "RMSE", "MAE", "NRMSE", "R2", "ECE", "Coverage95"], out,
                 "table3_overall")
    per_state = [{"Model": name, **{s: m.get(f"rmse_{s.lower()}") for s in STATE_NAMES}}
                 for name, m in metrics_by_model.items()]
    _write_table(per_state, ["Model", *STATE_NAMES], out, "table4_per_state")
    _write_table(overall, ["Model", "RMSE", "MAE", "ECE"], out, "table5_models")
    logger.info("tables written to %s", out)


def main(argv=None) -> None:
    """Figures and tables of a checkpoint on the seed-42 test split."""
    import argparse

    from hybrid_ode_torch.data.dataset import create_data_arrays, split_dataset
    from hybrid_ode_torch.evals.evaluate import evaluate_model
    from hybrid_ode_torch.models.hybrid import config_from_dict
    from hybrid_ode_torch.utils.checkpoint import load_checkpoint
    from hybrid_ode_torch.utils.convert import params_from_numpy

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Generate figures and tables")
    ap.add_argument("--checkpoint", type=str, required=True)
    ap.add_argument("--data", type=str, default="data/4gi_dataset.csv")
    ap.add_argument("--figures", type=str, default="all",
                    choices=["all", "fig1", "fig2", "fig3", "tables"])
    ap.add_argument("--out-dir", type=str, default="results")
    ap.add_argument("--sobol-samples", type=int, default=1024)
    ap.add_argument("--vi-checkpoint", type=str, default=None,
                    help="VI checkpoint dir: fig3 gets posterior bands and the tables "
                         "a VI row")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    state, meta = load_checkpoint(args.checkpoint)
    params = params_from_numpy(state["params"], device=args.device)
    config = config_from_dict(meta.get("config", {}))

    variational = None
    if args.vi_checkpoint:
        from hybrid_ode_torch.inference.vi import VariationalInference

        variational = VariationalInference.restore(args.vi_checkpoint, device=args.device)

    ds = create_data_arrays(args.data)
    _, _, test_ds = split_dataset(ds, seed=42)
    figdir = Path(args.out_dir) / "figures"

    if args.figures in ("all", "fig1"):
        plot_fig1_predictions(params, test_ds, config, str(figdir / "fig1_predictions.png"))
    if args.figures in ("all", "fig2"):
        plot_fig2_sensitivity(params, config, str(figdir / "fig2_sensitivity.png"),
                              n_samples=args.sobol_samples)
    if args.figures in ("all", "fig3"):
        plot_fig3_posterior_bands(params, test_ds, config, variational,
                                  str(figdir / "fig3_posterior.png"))
    if args.figures in ("all", "tables"):
        tables = {"Hybrid ODE-NN": evaluate_model(params, test_ds, config)}
        if variational is not None:
            tables["Hybrid ODE-NN (VI)"] = evaluate_model(
                variational.template, test_ds, variational.config, variational=variational,
                obs_sigma=variational.noise_sigma)
        generate_performance_tables(tables, str(Path(args.out_dir) / "tables"))


if __name__ == "__main__":
    main()
