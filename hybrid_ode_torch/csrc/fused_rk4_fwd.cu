// Fused fixed-step RK4 forward for the hybrid ODE-NN field, for Hopper (sm_90a).
//
// Replaces the TPU kernel `hybrid_ode_tpu/ops/pallas_rk4.py:_fwd_kernel`
// (with its device functions `_hybrid_field_t`, `_rk4_substep_t` and
// `_interval_inputs`). It integrates, for every sample b,
//
//   dy/dt = f_mech(y; 17 params, GD = 0) + MLP([t, y(6), GLP1, tVNS, ctx...])
//
// with (T-1)*substeps RK4 steps on the sample's own time grid, interpolating
// meal / tVNS linearly at stage offsets (j + c) / substeps, and writes the
// state at every observation point.
//
// What bounds it on an H100: arithmetic. At the cohort shape (B = 8192,
// T = 61, substeps = 4, H = 128, 16 context features) the MLP alone is
// 2 * 8192 * 960 * 53,120 = 8.4e11 FLOP against 19 MB of inputs and outputs,
// so the least time is the FLOP count over the card's f32 CUDA-core peak
// (67 TFLOP/s): about 12.6 ms. Tensor cores (TF32 / bf16) would change the
// numerics and are left to a later version.
//
// Design:
//   * One launch integrates the whole trajectory. A block owns TILE samples
//     and loops over every step and stage; nothing carries over between
//     blocks. Thread `tid < TILE` owns sample `blockIdx.x * TILE + tid`: its
//     state, RK4 stage sums and (per-sample) mechanistic parameters stay in
//     registers for the whole run. Rows are written to global memory only
//     at observation points.
//   * The packed f32 weights (217 KB at H = 128) do not fit in shared
//     memory beside the activations, so they are read from global memory
//     through the read-only path; they stay resident in the 50 MB L2.
//     Shared memory holds only the tile's activations: the feature block
//     X (in_pad x TILE), two hidden buffers (H x TILE) and the residual
//     (8 x TILE), 37 KB at H = 128.
//   * Each dense layer is a register-tiled product: a thread computes 4
//     output rows x 4 samples, reading a float4 of weights (row k of the
//     (in, out) layout) and a float4 of activations per k.
//   * Lanes past B are masked (no loads, no stores), not padded.
//
// mlp_dtype='bf16' is the template argument BF16 (fused_rk4_common.cuh): the
// products read their activations rounded to bf16 and `wpack` holds weights
// rounded by the caller; the f32 instantiation is the code without it.
//
// Built with -fmad=false (hybrid_ode_torch/ops/fused_rk4.py): the matmul
// loops use explicit fmaf; everything else rounds after each operation, as
// the plain PyTorch version's tensor ops do, so the adjoint's recomputed
// ReLU masks match the plain version's (kernel-vs-plain stays ~1e-6).
//
// Interface: a plain C function taking device pointers and the stream,
// loaded with ctypes (hybrid_ode_torch/ops/fused_rk4.py). It returns the
// cudaError_t of the launch.

#include "fused_rk4_common.cuh"

namespace {

using namespace fused_rk4;

// BF16: mlp_dtype='bf16', see fused_rk4_common.cuh.
template <bool BF16>
__global__ void __launch_bounds__(NTHREADS)
fused_rk4_fwd_kernel(const float* __restrict__ y0,    // (B, 6)
                     const float* __restrict__ ts,    // (T, B)
                     const float* __restrict__ meal,  // (T, B)
                     const float* __restrict__ tvns,  // (T, B)
                     const float* __restrict__ ctx,   // (C, B) or null
                     const float* __restrict__ wpack, // weights then biases
                     const float* __restrict__ pvec,  // (32,) PARAM_ORDER
                     const int* __restrict__ cidx,    // (n_cp,) or null
                     float* __restrict__ out,         // (T, 6, B)
                     int B, int T, int C, int in_pad, int H, int n_layers,
                     int substeps, int n_cp, int abs_mode) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [in_pad][TILE]
  float* Ha = X + in_pad * TILE;               // [H][TILE]
  float* Hb = Ha + H * TILE;                   // [H][TILE]
  float* R = Hb + H * TILE;                    // [NOUT][TILE]

  const int tid = threadIdx.x;
  const bool owner = tid < TILE;
  const int b = blockIdx.x * TILE + tid;
  const bool valid = owner && b < B;

  for (int i = tid; i < in_pad * TILE; i += NTHREADS) X[i] = 0.f;
  __syncthreads();

  float P[NP];
  float y[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) y[s] = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) P[p] = pvec[p];
  if (valid) {
    // params mode: context rows act per sample on the named parameters
#pragma unroll
    for (int p = 0; p < NP; ++p)
      for (int r = 0; r < n_cp; ++r)
        if (cidx[r] == p) {
          const float c = ctx[r * B + b];
          P[p] = abs_mode ? c : P[p] * expf(c);
        }
    if (n_cp == 0)  // features mode: context rows are MLP inputs, fixed per run
      for (int r = 0; r < C; ++r) X[(NF + r) * TILE + tid] = ctx[r * B + b];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      y[s] = y0[b * NS + s];
      out[s * B + b] = y[s];
    }
  }

  const float* bias0 = wpack + in_pad * H + (n_layers - 1) * H * H + H * NOUT;
  const float inv_s = 1.0f / (float)substeps;

  for (int i = 0; i + 1 < T; ++i) {
    float ts_l = 0.f, ts_r = 0.f, m_l = 0.f, m_r = 0.f, v_l = 0.f, v_r = 0.f;
    if (valid) {
      ts_l = ts[i * B + b];
      ts_r = ts[(i + 1) * B + b];
      m_l = meal[i * B + b];
      m_r = meal[(i + 1) * B + b];
      v_l = tvns[i * B + b];
      v_r = tvns[(i + 1) * B + b];
    }
    const float h = (ts_r - ts_l) * inv_s;
    for (int j = 0; j < substeps; ++j) {
      const float jf = (float)j;
      const float t = ts_l + jf * h;
      float k[NS], ksum[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) k[s] = ksum[s] = 0.f;
      for (int c = 0; c < 4; ++c) {
        if (owner) {
          // stage c: time offset 0, h/2, h/2, h; state from the last k
          const float off = c == 0 ? 0.f : (c == 3 ? h : 0.5f * h);
          const float alpha = c == 0 ? jf : (c == 3 ? jf + 1.0f : jf + 0.5f);
          const float tt = c == 0 ? t : t + off;
          float ys[NS];
#pragma unroll
          for (int s = 0; s < NS; ++s) ys[s] = c == 0 ? y[s] : y[s] + off * k[s];
          const float a = alpha * inv_s;
          const float m = m_l + (m_r - m_l) * a;
          const float v = v_l + (v_r - v_l) * a;
          X[tid] = tt;
#pragma unroll
          for (int s = 0; s < NS; ++s) X[(1 + s) * TILE + tid] = ys[s];
          X[7 * TILE + tid] = ys[3];
          X[8 * TILE + tid] = v;
          mech(ys, m, P, k);
        }
        __syncthreads();
        const float* w = wpack;
        const float* bias = bias0;
        const float* in = X;
        int K = in_pad;
        for (int l = 0; l < n_layers; ++l) {
          float* dst = (l & 1) ? Hb : Ha;
          dense<BF16>(w, bias, in, dst, nullptr, K, H, true);
          __syncthreads();
          w += K * H;
          bias += H;
          in = dst;
          K = H;
        }
        dense<BF16>(w, bias, in, R, nullptr, K, NOUT, false);
        __syncthreads();
        if (owner) {
          const float wgt = (c == 1 || c == 2) ? 2.0f : 1.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            k[s] += R[s * TILE + tid];
            ksum[s] = c == 0 ? k[s] : ksum[s] + wgt * k[s];
          }
        }
      }
      if (owner) {
        const float h6 = h / 6.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) y[s] = y[s] + h6 * ksum[s];
      }
    }
    if (valid) {
#pragma unroll
      for (int s = 0; s < NS; ++s) out[((i + 1) * NS + s) * B + b] = y[s];
    }
  }
}

}  // namespace

extern "C" int fused_rk4_fwd(const float* y0, const float* ts, const float* meal,
                             const float* tvns, const float* ctx,
                             const float* wpack, const float* pvec,
                             const int* cidx, float* out, int B, int T, int C,
                             int in_pad, int H, int n_layers, int substeps,
                             int n_cp, int abs_mode, int bf16, void* stream) {
  if (B < 1 || T < 1 || C < 0 || H < 4 || H % 4 != 0 || in_pad % 4 != 0 ||
      in_pad < NF + (n_cp ? 0 : C) || n_layers < 1 || substeps < 1 ||
      n_cp < 0 || n_cp > NP || (n_cp && n_cp != C) || (C && !ctx) ||
      (n_cp && !cidx) || (long long)T * NS * B > 0x7fffffffLL)  // int offsets
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(in_pad + 2 * H + NOUT) * TILE;
  auto kernel = bf16 ? fused_rk4_fwd_kernel<true> : fused_rk4_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TILE - 1) / TILE);
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      y0, ts, meal, tvns, ctx, wpack, pvec, cidx, out, B, T, C, in_pad, H,
      n_layers, substeps, n_cp, abs_mode);
  return (int)cudaGetLastError();
}
