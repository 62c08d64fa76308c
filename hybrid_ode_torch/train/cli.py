"""Training CLI, flag for flag the JAX package's (`hybrid_ode_tpu/train/cli.py`).

    python -m hybrid_ode_torch.train.cli --config configs/4gi_tuned.yaml --epochs 2
    python -m hybrid_ode_torch.train.cli --config ... --device cpu

Trains one model on CUDA unless `--device cpu`; writes runs/<experiment>/
(metrics.jsonl) and checkpoints/<experiment>/ (config.yaml, best_model,
final_model) under the working directory. Reading and writing the YAML
config needs PyYAML. `--vi` and `--mcmc` train a point model when the merged
config sets `ablation.no_bayes` (as the JAX CLI does) and are otherwise not
ported, nor is `--ensemble K>1`.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime
from pathlib import Path

logger = logging.getLogger("hybrid_ode_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train hybrid ODE-NN model (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--data", type=str, default=None,
                   help="Path to data file (default: config's data.path)")
    p.add_argument("--solver", type=str, default=None,
                   choices=["dopri5", "rk45", "dop853", "radau", "bdf", "rk4", "bosh3", "euler"])
    p.add_argument("--vi", action="store_true", help="Variational inference (not ported)")
    p.add_argument("--mcmc", action="store_true", help="NUTS after MAP pretrain (not ported)")
    p.add_argument("--no-nn", dest="no_nn", action="store_true")
    p.add_argument("--no-bayes", dest="no_bayes", action="store_true")
    p.add_argument("--no-physics", dest="no_physics", action="store_true")
    p.add_argument("--experiment-name", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--mcmc-chains", type=int, default=8)
    p.add_argument("--mcmc-samples", type=int, default=1000)
    p.add_argument("--mcmc-warmup", type=int, default=500)
    p.add_argument("--ensemble", type=int, default=1, metavar="K",
                   help="K deep-ensemble members (not ported; K=1 trains one model)")
    p.add_argument("--mcmc-engine", choices=["xla", "fused"], default="xla")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; 'cpu' for the CPU)")
    return p


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)

    from hybrid_ode_torch.data.dataset import create_data_arrays, split_dataset
    from hybrid_ode_torch.train.loop import train_model
    from hybrid_ode_torch.utils.config import load_config, merge_cli_overrides, save_config
    from hybrid_ode_torch.utils.device import resolve_device

    cfg = merge_cli_overrides(load_config(args.config), args)
    # as the JAX CLI: the merged config's no_bayes (flag or YAML) turns
    # --vi / --mcmc into point-model training
    bayes = not cfg["ablation"]["no_bayes"]
    if args.vi and bayes:
        raise NotImplementedError("--vi is not ported yet: ROADMAP Queue A 13")
    if args.mcmc and bayes:
        raise NotImplementedError("--mcmc is not ported yet: ROADMAP Queue A 13")
    if args.ensemble > 1:
        raise NotImplementedError("--ensemble K>1 is not ported yet: ROADMAP Queue A 11")

    device = resolve_device(args.device)
    if args.experiment_name:
        experiment = args.experiment_name
    else:
        experiment = f"hybrid_ode_nn_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
        if args.vi:
            experiment += "_vi"
        elif args.mcmc:
            experiment += "_mcmc"
        if cfg["ablation"]["no_nn"]:
            experiment += "_no_nn"
        if cfg["ablation"]["no_bayes"]:
            experiment += "_no_bayes"

    log_dir = Path("runs") / experiment
    ckpt_dir = Path("checkpoints") / experiment
    log_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, ckpt_dir / "config.yaml")
    logger.info("device: %s; experiment: %s", device, experiment)

    ds = create_data_arrays(
        cfg["data"]["path"],
        sequence_length=cfg["data"].get("sequence_length", 61),
        stride=cfg["data"].get("stride", 30),
        normalize=cfg["data"].get("normalize", True),
        per_channel_mask=cfg["data"].get("per_channel_mask", False),
    )
    train_ds, val_ds, test_ds = split_dataset(ds, seed=42,
                                              level=cfg["data"].get("split_level", "window"))
    logger.info("dataset: %d windows (train %d / val %d / test %d)",
                len(ds), len(train_ds), len(val_ds), len(test_ds))
    result = train_model(cfg, train_ds, val_ds, str(ckpt_dir), str(log_dir), device=device)
    logger.info("training done: best val loss %.4f over %d epochs",
                result.best_val_loss, result.epochs_run)


if __name__ == "__main__":
    main()
