"""YAML configuration, the JAX package's schema (`hybrid_ode_tpu/utils/config.py`).

Sections: data / model / training / ode_params / ablation / logging / seed,
plus ode_param_priors, vi_settings, clinical. `yaml` is imported only by the
two functions that read or write a file, so a caller that takes its config
from a checkpoint's metadata needs no PyYAML.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_CONFIG: Dict[str, Any] = {
    "data": {
        "path": "data/4gi_dataset.csv",
        "sequence_length": 61,
        "stride": 30,
        "normalize": True,
        "num_workers": 0,  # accepted for schema parity; unused
    },
    "model": {
        "nn_hidden": 64,
        "nn_layers": 4,
        "activation": "relu",
        "solver": "dopri5",
        "rtol": 1.0e-6,
        "atol": 1.0e-8,
        "mode": "scan",
        "max_steps_per_interval": 8,
        "substeps": 4,
        "use_variational": False,
    },
    "training": {
        "epochs": 300,
        "batch_size": 32,
        "learning_rate": 1.0e-3,
        "lambda1": 1.0,
        "lambda2": 1.0,
        "gradient_clip": 5.0,
        "early_stopping_patience": 20,
    },
    "ode_params": None,  # None => Table I defaults
    "ode_param_priors": None,
    "vi_settings": {"n_samples": 5, "kl_annealing": False, "annealing_epochs": 50},
    "clinical": None,
    "ablation": {"no_nn": False, "no_bayes": False, "no_physics": False},
    "logging": {"tensorboard": False, "log_interval": 10, "save_interval": 10},
    "seed": 0,
}


def default_config() -> Dict[str, Any]:
    return copy.deepcopy(DEFAULT_CONFIG)


def _deep_update(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: Optional[str]) -> Dict[str, Any]:
    """YAML config merged over the defaults (a missing file gives the defaults)."""
    cfg = default_config()
    if path and Path(path).exists():
        import yaml

        with open(path) as f:
            user = yaml.safe_load(f) or {}
        _deep_update(cfg, user)
    return cfg


def merge_cli_overrides(cfg: Dict[str, Any], args) -> Dict[str, Any]:
    """Apply argparse overrides (as the JAX package's CLI does)."""
    if getattr(args, "data", None):
        cfg["data"]["path"] = args.data
    if getattr(args, "solver", None):
        cfg["model"]["solver"] = args.solver
    for flag in ("no_nn", "no_bayes", "no_physics"):
        if getattr(args, flag, False):
            cfg["ablation"][flag] = True
    if cfg["ablation"]["no_bayes"]:
        cfg["training"]["lambda2"] = 0.0
    if getattr(args, "epochs", None) is not None:
        cfg["training"]["epochs"] = args.epochs
    if getattr(args, "batch_size", None) is not None:
        cfg["training"]["batch_size"] = args.batch_size
    if getattr(args, "seed", None) is not None:
        cfg["seed"] = args.seed
    if getattr(args, "vi", False):
        cfg["model"]["use_variational"] = True
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
