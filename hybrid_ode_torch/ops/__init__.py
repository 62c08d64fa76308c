"""Hand-written kernels and their plain PyTorch versions.

The JAX package's `pallas_available` (whether the TPU's Pallas backend
loads) has no counterpart: the CUDA kernels build at first use on the card
and the CPU runs their plain versions."""

from hybrid_ode_torch.ops.fused_rk4 import fused_rk4_trajectory

__all__ = ["fused_rk4_trajectory"]
