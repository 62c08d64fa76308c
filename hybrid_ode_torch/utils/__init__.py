"""Checkpoint reading and writing, parameter conversion, devices, config,
logging, profiling."""

from hybrid_ode_torch.utils.config import load_config, default_config, merge_cli_overrides
from hybrid_ode_torch.utils.checkpoint import save_checkpoint, load_checkpoint
from hybrid_ode_torch.utils.logging import MetricsLogger
from hybrid_ode_torch.utils.profiling import debug_mode, trace

__all__ = [
    "load_config",
    "default_config",
    "merge_cli_overrides",
    "save_checkpoint",
    "load_checkpoint",
    "MetricsLogger",
    "debug_mode",
    "trace",
]
