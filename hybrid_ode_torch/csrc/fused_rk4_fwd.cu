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
// (67 TFLOP/s): about 12.6 ms. The f32 products stay on the CUDA cores (no
// TF32, no tensor cores): the port is held to f32 references at 1e-4.
//
// Design (fused_rk4_wide.cuh has the shared parts):
//   * One launch integrates the whole trajectory. A block owns a tile of
//     WTILE = 64 samples and loops over every step and stage; nothing carries
//     over between blocks. Thread `tid < WTILE` owns sample
//     `blockIdx.x * WTILE + tid`: its state, RK4 stage sums and (per-sample)
//     mechanistic parameters stay in registers for the whole run. Rows are
//     written to global memory only at observation points.
//   * One block per SM (the cohort's 128 tiles are one wave on 132 SMs). Its
//     shared memory holds the tile's activations (feature block X, two hidden
//     buffers, the residual: 76 KB at H = 128) and two weight buffers of one
//     layer each (2 x 64 KB). Layer l + 1 arrives by cp.async while layer l
//     multiplies; the next stage's first layer arrives during the last layer
//     and the owner phase. Route `staged`: taken when both buffers fit in the
//     227 KB a block can get, i.e. H <= 128 at the usual input widths.
//     Otherwise (H up to about 430) the same products read the weights from
//     global memory through the read-only path.
//   * Each hidden layer is a register-tiled product: a thread computes 8
//     output rows x 4 samples (4 x 4 when H < 128, so that every thread still
//     has a tile), 32 FMA per two broadcast float4 of weights and one float4
//     of activations, all from shared memory.
//   * The last layer (8 rows) is spread over all threads, two rows and one
//     sample each, K sequential.
//   * Accumulation order: k ascending from 0 by fmaf, then the bias, then the
//     ReLU (fused_rk4_wide.cuh), so the adjoint kernels, which take the same
//     products, rebuild bitwise equal pre-activations.
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

#include "fused_rk4_wide.cuh"

namespace {

using namespace fused_rk4;

// BF16: mlp_dtype='bf16'; RT: output rows per thread of a hidden layer's
// product; STAGED: weights through shared memory (fused_rk4_wide.cuh).
template <bool BF16, int RT, bool STAGED>
__global__ void __launch_bounds__(NTHREADS, 1)
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
                     int substeps, int n_cp, int abs_mode, int wcap) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [in_pad][WTILE]
  float* Ha = X + in_pad * WTILE;              // [H][WTILE]
  float* Hb = Ha + H * WTILE;                  // [H][WTILE]
  float* R = Hb + H * WTILE;                   // [NOUT][WTILE]
  Ring ring;
  ring.init(R + NOUT * WTILE, wcap);           // [2][wcap] when STAGED

  const int tid = threadIdx.x;
  const bool owner = tid < WTILE;
  const int b = blockIdx.x * WTILE + tid;
  const bool valid = owner && b < B;
  const int L = n_layers;
  auto w_src = [&](int l) { return wpack + layer_offset(l, in_pad, H); };
  auto w_n = [&](int l) { return layer_floats(l, in_pad, H, L); };

  fetch_weights<STAGED>(ring, w_src(0), w_n(0));
  for (int i = tid; i < in_pad * WTILE; i += NTHREADS) X[i] = 0.f;
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
      for (int r = 0; r < C; ++r) X[(NF + r) * WTILE + tid] = ctx[r * B + b];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      y[s] = y0[b * NS + s];
      out[s * B + b] = y[s];
    }
  }

  const float* bias0 = wpack + layer_offset(L, in_pad, H) + H * NOUT;
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
          for (int s = 0; s < NS; ++s) X[(1 + s) * WTILE + tid] = ys[s];
          X[7 * WTILE + tid] = ys[3];
          X[8 * WTILE + tid] = v;
          mech(ys, m, P, k);
        }
        const float* in = X;
        int K = in_pad;
        for (int l = 0; l < L; ++l) {
          // the barrier inside publishes X / the last layer's output too
          const float* W = weights_ready<STAGED>(ring, w_src(l));
          fetch_weights<STAGED>(ring, w_src(l + 1), w_n(l + 1));
          float* dst = (l & 1) ? Hb : Ha;
          const float* bias = bias0 + l * H;
          dense_w<BF16, RT>(W, in, K, H, NoTag(),
                            [&](int, int n0, int sq, int rows, float (&acc)[RT][4], int) {
                              bias_relu<RT>(acc, bias, n0, rows);
                              store_tile<RT>(dst, n0, sq, rows, acc);
                            });
          in = dst;
          K = H;
        }
        const float* W = weights_ready<STAGED>(ring, w_src(L));
        fetch_weights<STAGED>(ring, w_src(0), w_n(0));  // the next stage's first layer
        dense_out<BF16>(W, bias0 + L * H, in, R, K);
        __syncthreads();
        if (owner) {
          const float wgt = (c == 1 || c == 2) ? 2.0f : 1.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            k[s] += R[s * WTILE + tid];
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
  __pipeline_wait_prior(0);  // the last stage fetched a layer nobody will use
}

// Shared memory of a block and its route for these widths: 0 on success.
int fwd_layout(int in_pad, int H, int n_layers, size_t* smem, int* wcap, int* staged) {
  const size_t acts = sizeof(float) * (size_t)(in_pad + 2 * H + NOUT) * WTILE;
  *wcap = max_layer_floats(in_pad, H, n_layers);
  const size_t both = acts + 2 * sizeof(float) * (size_t)*wcap;
  *staged = both <= (size_t)SMEM_LIMIT;
  *smem = *staged ? both : acts;
  return *smem <= (size_t)SMEM_LIMIT ? 0 : (int)cudaErrorInvalidValue;
}

template <bool BF16, int RT, bool STAGED>
cudaError_t launch(size_t smem, int grid, cudaStream_t stream, const float* y0,
                   const float* ts, const float* meal, const float* tvns, const float* ctx,
                   const float* wpack, const float* pvec, const int* cidx, float* out, int B,
                   int T, int C, int in_pad, int H, int n_layers, int substeps, int n_cp,
                   int abs_mode, int wcap) {
  auto kernel = fused_rk4_fwd_kernel<BF16, RT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      y0, ts, meal, tvns, ctx, wpack, pvec, cidx, out, B, T, C, in_pad, H, n_layers,
      substeps, n_cp, abs_mode, wcap);
  return cudaGetLastError();
}

}  // namespace

// tile[0] = samples per block: what a caller needs to cross a tile's edge.
extern "C" int fused_rk4_fwd_tile(int* tile) {
  *tile = WTILE;
  return 0;
}

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
  size_t smem;
  int wcap, staged;
  if (fwd_layout(in_pad, H, n_layers, &smem, &wcap, &staged)) return (int)cudaErrorInvalidValue;
  const int grid = (B + WTILE - 1) / WTILE;
  const bool rt8 = (H / 8) * WSQ >= NTHREADS;  // else 4 rows, so that no thread idles
  auto go = [&](auto fn) {
    return (int)fn(smem, grid, (cudaStream_t)stream, y0, ts, meal, tvns, ctx, wpack, pvec,
                   cidx, out, B, T, C, in_pad, H, n_layers, substeps, n_cp, abs_mode, wcap);
  };
  if (bf16) {
    if (staged) return rt8 ? go(launch<true, 8, true>) : go(launch<true, 4, true>);
    return rt8 ? go(launch<true, 8, false>) : go(launch<true, 4, false>);
  }
  if (staged) return rt8 ? go(launch<false, 8, true>) : go(launch<false, 4, true>);
  return rt8 ? go(launch<false, 8, false>) : go(launch<false, 4, false>);
}
