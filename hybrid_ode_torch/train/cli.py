"""Training CLI, flag for flag the JAX package's (`hybrid_ode_tpu/train/cli.py`).

    python -m hybrid_ode_torch.train.cli --config configs/4gi_tuned.yaml --epochs 2
    python -m hybrid_ode_torch.train.cli --config ... --device cpu
    python -m hybrid_ode_torch.train.cli --config configs/4gi_identified_ensemble.yaml --ensemble 8

Trains on CUDA unless `--device cpu`; writes runs/<experiment>/
(metrics.jsonl) and checkpoints/<experiment>/ (config.yaml, best_model,
final_model; with `--ensemble K` > 1 a K-member deep ensemble trained in one
pass, `ensemble_model`) under the working directory. Reading and writing the
YAML config needs PyYAML; `main(argv, config=...)` takes the config as a
dict instead (written as config.json), which needs none.

Bayesian runs, unless the merged config sets `ablation.no_bayes` (then, as
in the JAX CLI, `--vi` and `--mcmc` train a point model):

    python -m hybrid_ode_torch.train.cli --config configs/4gi_vi.yaml --vi
    python -m hybrid_ode_torch.train.cli --config configs/default.yaml --solver rk4 \
        --mcmc --mcmc-engine fused --mcmc-chains 1024 --mcmc-warmup 100 --mcmc-samples 200

`--vi`: a MAP pretrain of at most 20 epochs, then variational inference
(`vi_settings`), checkpoint `vi_model`. `--mcmc`: a MAP pretrain of at most
50 epochs, then NUTS on the first validation batch (`--mcmc-engine fused`
needs an rk4 / relu model without context), `mcmc_samples.npz` and
`mcmc_results` (NetCDF through h5py, else npz).
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--vi", action="store_true", help="Variational inference after a MAP pretrain")
    p.add_argument("--mcmc", action="store_true", help="NUTS after a MAP pretrain")
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
                   help="train a K-member deep ensemble (K=1 trains one model)")
    p.add_argument("--mcmc-engine", choices=["xla", "fused"], default="xla")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; 'cpu' for the CPU)")
    return p


def main(argv=None, config=None) -> None:
    """Parse `argv` and train. `config`: a config dict merged over the
    defaults in place of the `--config` YAML file."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)

    from hybrid_ode_torch.data.dataset import create_data_arrays, split_dataset
    from hybrid_ode_torch.train.loop import train_model
    from hybrid_ode_torch.utils.config import (
        _deep_update,
        default_config,
        load_config,
        merge_cli_overrides,
        save_config,
    )
    from hybrid_ode_torch.utils.device import resolve_device

    base = (load_config(args.config) if config is None
            else _deep_update(default_config(), json.loads(json.dumps(config))))
    cfg = merge_cli_overrides(base, args)
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
    if config is None:
        save_config(cfg, ckpt_dir / "config.yaml")
    else:
        (ckpt_dir / "config.json").write_text(json.dumps(cfg, indent=1))
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
    seed = cfg.get("seed", 0)
    # as the JAX CLI: the merged config's no_bayes (flag or YAML) turns
    # --vi / --mcmc into point-model training
    bayes = not cfg["ablation"]["no_bayes"]
    if args.vi and bayes:
        _run_vi(cfg, train_ds, val_ds, ckpt_dir, seed, device)
        return
    if args.mcmc and bayes:
        _run_mcmc(cfg, args, train_ds, val_ds, ckpt_dir, log_dir, seed, device)
        return
    if args.ensemble > 1:
        _run_ensemble(cfg, args.ensemble, train_ds, val_ds, ckpt_dir, seed, device)
        return
    result = train_model(cfg, train_ds, val_ds, str(ckpt_dir), str(log_dir), device=device)
    logger.info("training done: best val loss %.4f over %d epochs",
                result.best_val_loss, result.epochs_run)


def _run_ensemble(cfg, K, train_ds, val_ds, ckpt_dir, seed, device):
    """Train a K-member deep ensemble in one pass and save the stacked-params
    checkpoint `ensemble_model` (leaves carry a leading member axis) with the
    JAX package's metadata keys."""
    import numpy as np

    from hybrid_ode_torch.data.dataset import batch_iterator, pad_batch
    from hybrid_ode_torch.models.hybrid import config_from_dict
    from hybrid_ode_torch.parallel.ensemble import (
        ensemble_predictive,
        init_ensemble,
        make_ensemble_optimizer,
        train_ensemble,
    )
    from hybrid_ode_torch.utils.checkpoint import save_checkpoint

    config = config_from_dict(cfg, use_pallas=False)  # one weight set per kernel launch
    tr_cfg = cfg["training"]
    batch_size = tr_cfg.get("batch_size", 32)
    epochs = tr_cfg.get("epochs", 100)
    # one shuffled composition of the train batches; train_ensemble permutes
    # their order every epoch
    batches = [pad_batch(b, batch_size)[0]
               for b in batch_iterator(train_ds, batch_size, shuffle=True, seed=seed)]
    val_batches = [pad_batch(b, batch_size)[0]
                   for b in batch_iterator(val_ds, batch_size, shuffle=False)]
    opt = make_ensemble_optimizer(tr_cfg.get("learning_rate", 1e-3), epochs, len(batches),
                                  tr_cfg.get("gradient_clip", 5.0),
                                  train_ode_params=tr_cfg.get("train_ode_params", False))
    stacked, best_val, metrics = train_ensemble(
        init_ensemble(seed, config, K, device=device), opt, config, batches, val_batches,
        seed + 1, epochs,
        lambda1=tr_cfg.get("lambda1", 1.0),
        lambda2=tr_cfg.get("lambda2", 0.01),
        use_physics=not cfg["ablation"].get("no_physics", False),
        eval_every=max(1, cfg.get("logging", {}).get("log_interval", 10)),
    )
    logger.info("ensemble final member losses %s; best val %s",
                np.round(metrics["loss"], 4), np.round(best_val, 4))
    # ensemble-mean validation fit (normalised RMSE over observed points)
    val_rmse = float("nan")
    if val_batches:
        se, wsum = 0.0, 0.0
        for vb in val_batches:
            mean, _ = ensemble_predictive(stacked, vb, config)
            err = mean.cpu().numpy() - vb["observations"]
            w = vb["mask"][..., None] * np.ones_like(err)
            se += float((err ** 2 * w).sum())
            wsum += float(w.sum())
        val_rmse = float(np.sqrt(se / max(wsum, 1.0)))
    logger.info("ensemble (K=%d) trained %d epochs; val RMSE (ens-mean, z) %.4f",
                K, epochs, val_rmse)
    save_checkpoint(str(Path(ckpt_dir) / "ensemble_model"), stacked,
                    {"config": cfg, "n_members": K, "val_rmse_ensemble": val_rmse,
                     "best_val": [float(x) for x in best_val],
                     "epoch": epochs, "val_loss": val_rmse})


def _run_vi(cfg, train_ds, val_ds, ckpt_dir, seed, device):
    """A short MAP pretrain (its checkpoints saved too: the VI template is
    its result), then VI with the config's `vi_settings` and priors;
    checkpoint `vi_model`."""
    from hybrid_ode_torch.inference.vi import VariationalInference
    from hybrid_ode_torch.models.hybrid import config_from_dict
    from hybrid_ode_torch.train.loop import train_model

    logger.info("VI: MAP pretrain (<=20 epochs)")
    pre = train_model(cfg, train_ds, val_ds, str(ckpt_dir), None,
                      max_epochs=min(20, cfg["training"]["epochs"]), device=device)
    vcfg = cfg.get("vi_settings") or {}
    vi = VariationalInference(
        pre.params, config_from_dict(cfg),
        prior_params=cfg.get("ode_param_priors"),
        learning_rate=cfg["training"]["learning_rate"],
        n_samples=vcfg.get("n_samples", 5),
        noise_sigma=vcfg.get("noise_sigma", 0.35),
        kl_annealing=vcfg.get("kl_annealing", False),
        annealing_epochs=vcfg.get("annealing_epochs", 50),
        include_nn=vcfg.get("include_nn", False),
    )
    vi.train(train_ds, val_ds, epochs=cfg["training"]["epochs"],
             batch_size=cfg["training"]["batch_size"],
             early_stopping_patience=cfg["training"].get("early_stopping_patience", 10),
             seed=seed)
    vi.save_checkpoint(str(Path(ckpt_dir) / "vi_model"))
    logger.info("VI training complete; checkpoint at %s", ckpt_dir)


def _run_mcmc(cfg, args, train_ds, val_ds, ckpt_dir, log_dir, seed, device):
    """A MAP pretrain of at most 50 epochs, then NUTS on the first
    validation batch with the config's own solver; writes mcmc_samples.npz
    and mcmc_results and logs the posterior summary."""
    import numpy as np
    import torch

    from hybrid_ode_torch.data.dataset import batch_iterator
    from hybrid_ode_torch.inference.mcmc import posterior_summary, run_nuts, save_mcmc_results
    from hybrid_ode_torch.models.hybrid import config_from_dict
    from hybrid_ode_torch.train.loop import train_model

    logger.info("MCMC: MAP pretrain (<=50 epochs)")
    pre = train_model(cfg, train_ds, val_ds, str(ckpt_dir), str(log_dir),
                      max_epochs=min(50, cfg["training"]["epochs"]), device=device)
    batch = next(batch_iterator(val_ds, cfg["training"]["batch_size"], shuffle=False))
    samples = run_nuts(
        pre.params, batch, config_from_dict(cfg),
        generator=torch.Generator(device).manual_seed(seed),
        num_samples=args.mcmc_samples, num_warmup=args.mcmc_warmup,
        n_chains=args.mcmc_chains, engine=args.mcmc_engine,
    )
    np.savez(Path(ckpt_dir) / "mcmc_samples.npz", **samples)
    save_mcmc_results(samples, str(Path(ckpt_dir) / "mcmc_results"))
    for name, st in posterior_summary(samples).items():
        logger.info("  %s: mean=%.4g std=%.3g [%.4g, %.4g]",
                    name, st["mean"], st["std"], st["q025"], st["q975"])


if __name__ == "__main__":
    main()
