"""hybrid_ode_torch — PyTorch/CUDA port of `hybrid_ode_tpu` for NVIDIA Hopper.

The JAX package `hybrid_ode_tpu/` is the reference; every module here
mirrors the module of the same name there and is tested against it on the
CPU (`tests/test_torch_*.py`). This package never imports JAX or
`hybrid_ode_tpu`.

Layering (bottom-up), serving, training, identification, adaptive-solver,
ensemble and Bayesian paths so far:
  dynamics/   mechanistic 6-state field, MLP residual, piecewise-linear
              controls, the 8-state 4GI simulator field
  solvers/    fixed-grid RK4 / Euler, adaptive explicit RK (scan, while,
              dense, sync, backsolve)
  ops/        fused RK4 forward and two adjoints: hand-written CUDA kernels
              (csrc/) + plain torch versions, paired as a
              torch.autograd.Function
  models/     hybrid model composition, config, fused dispatch, context
              encoder, test-time identification, hybrid_loss
  data/       CSV windowing (no pandas; a native C++ route), splits,
              batching, the 4GI cohort generator
  parallel/   deep ensembles on one device: training, identification,
              prediction with the member axis written out
  inference/  variational inference and NUTS (the fused engine runs the
              chains on the fused kernels' lanes), diagnostics
  evals/      metrics, recalibration fits and checkpoint evaluation
              (point models, ensembles, VI posteriors)
  train/      optimizer (clip + Adam + cosine), train_model, CLI
  utils/      checkpoint reader / writer, JAX-pytree <-> tensor conversion,
              devices, YAML config, metrics logging

Entry points run on CUDA unless the caller passes `device="cpu"`; asking for
CUDA where there is none raises.
"""

__version__ = "0.1.0"
