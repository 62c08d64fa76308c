"""hybrid_ode_torch — PyTorch/CUDA port of `hybrid_ode_tpu` for NVIDIA Hopper.

The JAX package `hybrid_ode_tpu/` is the reference; every module here
mirrors the module of the same name there and is tested against it on the
CPU (`tests/test_torch_*.py`). This package never imports JAX or
`hybrid_ode_tpu`.

Layering (bottom-up), serving, training and identification paths so far:
  dynamics/   mechanistic 6-state field, MLP residual, piecewise-linear controls
  solvers/    fixed-grid RK4 / Euler
  ops/        fused RK4 forward and two adjoints: hand-written CUDA kernels
              (csrc/) + plain torch versions, paired as a
              torch.autograd.Function
  models/     hybrid model composition, config, fused dispatch, context
              encoder, test-time identification, hybrid_loss
  data/       CSV windowing (no pandas), splits, batching
  evals/      metrics and checkpoint evaluation
  train/      optimizer (clip + Adam + cosine), train_model, CLI
  utils/      checkpoint reader / writer, JAX-pytree <-> tensor conversion,
              devices, YAML config, metrics logging

Entry points run on CUDA unless the caller passes `device="cpu"`; asking for
CUDA where there is none raises.
"""

__version__ = "0.1.0"
