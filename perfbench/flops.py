"""Operations and bytes of the fused RK4 kernels, and the H100's peaks.

A copy of `chip_smoke.py`'s `kernel_ops` and `bound`: the operations are
counted from the kernels' formulas (unpadded MLP widths), the bytes are each
input read once and each output written once. Peaks are NVIDIA's H100 SXM
data sheet at 700 W: f32 outside the tensor cores (TF32 is off), HBM3.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# operations per sample outside the MLP, counted from the kernel's formulas:
# mechanistic drift + residual add + stage state + control interpolation per
# stage evaluation, and the RK4 combination per step
MECH_OPS_PER_STAGE = 61
RK_OPS_PER_STEP = 48
# ... and for the adjoint: mechanistic Jacobian-transpose, parameter rows and
# stage cotangents per stage, the substep's cotangent sum per step
MECH_T_OPS_PER_STAGE = 124
RK_T_OPS_PER_STEP = 30
N_PARAMS = 17  # mechanistic parameters the kernels read, and the adjoint's rows


def mlp_sizes(widths: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """(multiply-adds, outputs) of one MLP evaluation with layers of
    (in, out) widths."""
    return sum(a * b for a, b in widths), sum(b for _, b in widths)


def field_widths(in_dim: int, hidden: int, n_layers: int, out_dim: int = 6):
    """(in, out) widths of the residual MLP's n_layers + 1 layers."""
    dims = [in_dim] + [hidden] * n_layers + [out_dim]
    return list(zip(dims[:-1], dims[1:]))


def kernel_ops(widths, n_layers: int, hidden: int, B: int, T: int, substeps: int,
               n_ctx_feat: int = 0) -> Tuple[float, float]:
    """Operations of the forward and of the hand-adjoint kernel on these
    shapes. `n_ctx_feat`: context features of the MLP (feature mode), whose
    cotangent rows the adjoint adds up."""
    macs, outs = mlp_sizes(widths)
    hidden_outs = n_layers * hidden
    steps = B * (T - 1) * substeps
    fwd = steps * (4 * (2 * macs + outs + hidden_outs + MECH_OPS_PER_STAGE) + RK_OPS_PER_STEP)
    # the adjoint: one recomputed forward, then per stage the weight and input
    # cotangents (2 x 2 macs), bias sums, ReLU masks and the mechanistic transpose
    bwd = fwd + steps * (4 * (4 * macs + outs + hidden_outs + MECH_T_OPS_PER_STAGE + n_ctx_feat)
                         + RK_T_OPS_PER_STEP)
    return float(fwd), float(bwd)


def kernel_bytes(n_weights: int, B: int, T: int, C: int) -> Tuple[float, float]:
    """Bytes the forward and the hand adjoint must move: inputs read once
    (time grid, meal and tVNS rows, C context rows, weights, parameter row),
    outputs written once (the forward's trajectory; the adjoint's state,
    weight, per-sample parameter and context cotangents, after reading the
    trajectory and its cotangent)."""
    in_bytes = 4 * (3 * T * B + C * B + n_weights + 32)
    fwd = in_bytes + 4 * (B * 6 + T * 6 * B)
    bwd = in_bytes + 4 * (2 * T * 6 * B + B * 6 + n_weights + N_PARAMS * B + C * B)
    return float(fwd), float(bwd)


def bound(ops: float, nbytes: float):
    """(least time in ms, 'operations' or 'bytes', ms at the f32 peak, ms at
    the HBM peak)."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def mlp_ops(widths, rows: int) -> float:
    """Operations of one plain MLP evaluation over `rows` rows (multiply-adds
    twice, bias adds, ReLUs of the hidden layers)."""
    macs, outs = mlp_sizes(widths)
    hidden_outs = sum(b for _, b in widths[:-1])
    return float(rows * (2 * macs + outs + hidden_outs))
