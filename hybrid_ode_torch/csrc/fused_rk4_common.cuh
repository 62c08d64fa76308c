// Shared by the three fused RK4 kernels (fused_rk4_fwd.cu, fused_rk4_bwd.cu,
// fused_rk4_bwd_vjp.cu): the block constants, the parameter order, the
// mechanistic drift `mech`, which all three must take operation for operation
// alike so that an adjoint rebuilds exactly the states the forward took (the
// MLP products they share are in fused_rk4_wide.cuh), and `sum_rows`, which
// adds the adjoints' per-block slices in block order.
//
// BF16 (template argument, `mlp_dtype='bf16'`): every MLP product reads its
// activation operand rounded to bf16 (round to nearest even) and accumulates
// in f32; the weights arrive already rounded from the host. With BF16 false
// the code is the f32 path unchanged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_rk4 {

constexpr int NTHREADS = 256;  // threads per block
constexpr int NP = 17;         // mechanistic parameters, PARAM_ORDER
constexpr int NS = 6;          // states
constexpr int NF = 9;          // features before the context: t, y(6), GLP1, tVNS
constexpr int NOUT = 8;        // last layer's output rows (6 used, 2 zero pad)

// PARAM_ORDER indices (hybrid_ode_torch/ops/fused_rk4.py)
enum { A_GI, K_I, RHO, G_B, I_B, E_MAX, EC_50, GLU_B, V_MAX, K_M, K_L,
       K_GE0, IGD_50, HILL_G, P_7, P_8, P_9 };

// An MLP product's operand: rounded to bf16 when BF16, else as it is.
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

// Mechanistic drift with GD = 0 (so k_GE = k_GE0); the GE row is zero.
__device__ __forceinline__ void mech(const float* y, float meal, const float* P,
                                     float* d) {
  const float G = y[0], I = y[1], Glu = y[2], GLP1 = y[3], FFA = y[5];
  const float Pi = 1.f + P[RHO] * GLP1;
  d[1] = Pi * P[A_GI] * (G - P[G_B]) - P[K_I] * (I - P[I_B]);
  const float glp1_eff = P[E_MAX] * GLP1 / (P[EC_50] + GLP1);
  d[2] = -glp1_eff * (Glu - P[GLU_B]);
  d[3] = P[V_MAX] * G / (P[K_M] + G) - P[K_L] * GLP1;
  d[5] = -P[P_7] * FFA - P[P_8] * I * FFA + P[P_9] * G * FFA;
  d[0] = meal - 0.01f * (I - P[I_B]) + 0.005f * (Glu - P[GLU_B]) - P[K_GE0] * G;
  d[4] = 0.f;
}

// out[e] = sum_g rows[g][e] for e < n, g in order: the deterministic sum of
// the per-block slices the adjoint kernels write.
static __global__ void sum_rows(const float* __restrict__ rows, int n_rows, int n,
                                float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int g = 0; g < n_rows; ++g) s += rows[(size_t)g * n + e];
  out[e] = s;
}

}  // namespace fused_rk4
