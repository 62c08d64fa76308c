"""hybrid_ode_torch — PyTorch/CUDA port of `hybrid_ode_tpu` for NVIDIA Hopper.

The JAX package `hybrid_ode_tpu/` is the reference; every module here
mirrors the module of the same name there and is tested against it on the
CPU (`tests/test_torch_*.py`). This package never imports JAX or
`hybrid_ode_tpu`.

Layering (bottom-up):
  dynamics/   mechanistic 6-state field, MLP residual, piecewise-linear
              controls, the 8-state 4GI simulator field
  solvers/    fixed-grid RK4 / Euler, adaptive explicit RK (scan, while,
              dense, sync, backsolve), implicit Radau IIA, BDF 1-5 and BDF2
  ops/        fused RK4 forward and two adjoints: hand-written CUDA kernels
              (csrc/) + plain torch versions, paired as a
              torch.autograd.Function
  models/     hybrid model composition, config, fused dispatch, context
              encoder, test-time identification, hybrid_loss, Bayesian
              parameters, closed-loop insulin protocols and their optimiser
  data/       CSV and Parquet windowing (no pandas; a native C++ route;
              pyarrow imported for Parquet only), splits, batching, the 4GI,
              MIMIC-like and ICU cohort generators
  parallel/   deep ensembles (training, identification, prediction with
              the member axis written out) and the multi-device layer on
              torch.distributed: meshes, batch placement, the data-parallel
              train step and cohort simulator, member-sharded ensembles
  inference/  variational inference and NUTS (the fused engine runs the
              chains on the fused kernels' lanes), diagnostics
  evals/      metrics, recalibration fits and checkpoint evaluation
              (point models, ensembles, VI posteriors), robustness sweeps,
              latent-recovery metrics
  plots/      Sobol sensitivity, figures and tables (matplotlib / pandas
              imported when drawing / writing LaTeX)
  train/      optimizer (clip + Adam + cosine), train_model, CLI
  utils/      checkpoint reader / writer, JAX-pytree <-> tensor conversion,
              devices, YAML config, metrics logging, profiling

Entry points run on CUDA unless the caller passes `device="cpu"`; asking for
CUDA where there is none raises.

The package re-exports the names the JAX package does, here and in each
sub-package. pandas, pyarrow, matplotlib and PyYAML are imported only by the
functions that need them. The JAX package's `ops.pallas_available` has no
counterpart: the CUDA kernels build at first use on the card.
"""

__version__ = "0.1.0"

from hybrid_ode_torch.dynamics.ode_core import (
    DEFAULT_ODE_PARAMS,
    mechanistic_field,
    steady_state,
)
from hybrid_ode_torch.dynamics.residual import init_mlp_params, mlp_apply
from hybrid_ode_torch.solvers.api import odeint
from hybrid_ode_torch.models.hybrid import (
    HybridConfig,
    init_hybrid_params,
    hybrid_field,
    forward,
    batched_forward,
    hybrid_loss,
)

__all__ = [
    "DEFAULT_ODE_PARAMS",
    "mechanistic_field",
    "steady_state",
    "init_mlp_params",
    "mlp_apply",
    "odeint",
    "HybridConfig",
    "init_hybrid_params",
    "hybrid_field",
    "forward",
    "batched_forward",
    "hybrid_loss",
]
