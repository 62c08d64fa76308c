// Fused reverse-time RK4 adjoint for the hybrid ODE-NN field, for Hopper (sm_90a).
//
// Replaces the TPU kernel `hybrid_ode_tpu/ops/pallas_rk4.py:_bwd_kernel_hand`
// (the default backward of `fused_rk4_hybrid`). Given the forward's
// observation-grid trajectory traj (T, 6, B) and its cotangent gbar
// (T, 6, B), it computes, for the discrete RK4 map of
// hybrid_ode_torch/csrc/fused_rk4_fwd.cu,
//   ybar0 (B, 6)     the cotangent of y0,
//   dflat            the cotangents of the packed MLP weights and biases,
//   dp (17, B)       per-sample cotangents of the effective mechanistic
//                    parameters (summed over the batch by the caller),
//   dctx (B, C)      context cotangents (feature mode: through the MLP
//                    input; params mode: the closed-form 'mul' / 'abs' fold).
//
// Per interval i = T-2 .. 0 a block runs ONE forward pass from traj[i] that
// saves every stage's MLP input X and post-ReLU activations, then walks the
// substeps backwards transposing stages 4, 3, 2, 1: the MLP transpose
// (ReLU mask acts > 0) and the hand-derived mechanistic Jacobian-transpose.
// The forward pass is fused_rk4_fwd.cu's stage evaluation
// (fused_rk4_common.cuh), so the states it rebuilds are the ones the forward
// took.
//
// What bounds it on an H100: arithmetic. Per stage evaluation the MLP is
// done three times (recompute, weight cotangent, input cotangent): at the
// cohort shape (B = 8192, T = 61, substeps = 4, H = 128, 16 context
// features) about 2.5e12 FLOP, 38 ms at the 67 TFLOP/s f32 CUDA-core peak,
// against about 30 MB of inputs and outputs.
//
// Design, and what it does about the TPU kernel's assumptions:
//   * Weight cotangents. On the TPU every grid step adds into one resident
//     output. Here blocks run in no order, so block g accumulates into its
//     own slice partials[g] (the packed weight layout) with plain
//     read-modify-writes: no other block touches it, so no atomics.
//     `sum_rows` (fused_rk4_common.cuh) then adds the slices in block order, so gradients do
//     not depend on scheduling. The read-modify-write happens once per
//     stage (simple, about 217 KB each way per stage and block at H = 128);
//     batching it per interval is left to a later version.
//   * Saved activations (in_pad + L*H floats per sample and stage, 1.1 MB
//     per interval for a 32-sample tile) do not fit in shared memory. They
//     go to a per-block slice of global `scratch` and are read back in the
//     reverse sweep, mostly from L2.
//   * The grid is the number of blocks that can be resident at once, at
//     most one per 32-sample tile; block g walks tiles g, g + gridDim.x, ...
//     so `partials` holds one slice per resident block, not per tile.
//   * Thread tid < TILE owns one sample: its RK4 cotangents live in
//     registers; its parameters, parameter cotangents, stage-state
//     cotangents and feature-mode context cotangents in shared memory.
//   * Each dense transpose is register-tiled like the forward (4 rows x 4
//     samples per thread, float4 loads of weights and activations).
//
// mlp_dtype='bf16' is the template argument BF16 (fused_rk4_common.cuh): both
// operands of every product, forward and transposed, are rounded to bf16 at
// the load (`wpack` arrives rounded); sums, bias cotangents, masks and every
// accumulator stay f32. The f32 instantiation is the code without it.
//
// Built with -fmad=false (hybrid_ode_torch/ops/fused_rk4.py): the matmul
// loops use explicit fmaf; everything else rounds after each operation, as
// the plain PyTorch version's tensor ops do, so the adjoint's recomputed
// ReLU masks match the plain version's (kernel-vs-plain stays ~1e-6).
//
// Interface: plain C functions taking device pointers and the stream, loaded
// with ctypes (hybrid_ode_torch/ops/fused_rk4.py). They return cudaError_t.

#include "fused_rk4_common.cuh"

namespace {

using namespace fused_rk4;

// out[k][s] = (sum_n W[k][n] * g[n][s]) * (mask[k][s] > 0 ? 1 : 0) for
// k < K, s < TILE (no mask factor when mask is null). W is (K, N) row-major:
// the transpose of the forward product, u = W g. BF16: g is read rounded.
template <bool BF16>
__device__ __forceinline__ void dense_t(const float* __restrict__ W,
                                        const float* g, float* out,
                                        const float* mask, int K, int N) {
  const int sq = threadIdx.x % SQ;
  const int n4 = N / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g) + sq;
  for (int rq = threadIdx.x / SQ; rq < K / 4; rq += NTHREADS / SQ) {
    const float4* w4 = reinterpret_cast<const float4*>(W) + 4 * rq * n4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int nq = 0; nq < n4; ++nq) {
      float wv[4][4], gv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 w = __ldg(w4 + i * n4 + nq);  // W[4rq+i][4nq .. 4nq+3]
        wv[i][0] = w.x; wv[i][1] = w.y; wv[i][2] = w.z; wv[i][3] = w.w;
        const float4 a = g4[(4 * nq + i) * SQ];     // g[4nq+i][4sq .. 4sq+3]
        gv[i][0] = operand<BF16>(a.x); gv[i][1] = operand<BF16>(a.y);
        gv[i][2] = operand<BF16>(a.z); gv[i][3] = operand<BF16>(a.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[i][s] = fmaf(wv[i][jj], gv[jj][s], acc[i][s]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = (4 * rq + i) * SQ + sq;
      float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      if (mask) {
        const float4 m = reinterpret_cast<const float4*>(mask)[idx];
        v[0] *= m.x > 0.f ? 1.f : 0.f;
        v[1] *= m.y > 0.f ? 1.f : 0.f;
        v[2] *= m.z > 0.f ? 1.f : 0.f;
        v[3] *= m.w > 0.f ? 1.f : 0.f;
      }
      reinterpret_cast<float4*>(out)[idx] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// D[k][n] += sum_s A[k][s] * G[n][s] for k < K, n < N (D row-major (K, N)),
// and Db[n] += sum_s G[n][s]. Element (k, n) is always updated by the same
// thread, so successive calls on one D need no barrier between them.
// BF16: A and G are read rounded for the product; the bias sum takes G as it is.
template <bool BF16>
__device__ __forceinline__ void outer_acc(float* D, float* Db, const float* A,
                                          const float* G, int K, int N) {
  const int n4 = N / 4;
  for (int it = threadIdx.x; it < (K / 4) * n4; it += NTHREADS) {
    const int kq = it / n4, nq = it % n4;
    float4* d4 = reinterpret_cast<float4*>(D) + 4 * kq * n4 + nq;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d = d4[i * n4];
      acc[i][0] = d.x; acc[i][1] = d.y; acc[i][2] = d.z; acc[i][3] = d.w;
    }
    for (int sq = 0; sq < SQ; ++sq) {
      float av[4][4], gv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = reinterpret_cast<const float4*>(A)[(4 * kq + i) * SQ + sq];
        av[i][0] = operand<BF16>(a.x); av[i][1] = operand<BF16>(a.y);
        av[i][2] = operand<BF16>(a.z); av[i][3] = operand<BF16>(a.w);
        const float4 g = reinterpret_cast<const float4*>(G)[(4 * nq + i) * SQ + sq];
        gv[i][0] = operand<BF16>(g.x); gv[i][1] = operand<BF16>(g.y);
        gv[i][2] = operand<BF16>(g.z); gv[i][3] = operand<BF16>(g.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[i][j] = fmaf(av[i][s], gv[j][s], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d4[i * n4] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  for (int n = threadIdx.x; n < N; n += NTHREADS) {
    float s = 0.f;
    for (int j = 0; j < TILE; ++j) s += G[n * TILE + j];
    Db[n] += s;
  }
}

// Transpose of the mechanistic drift at stage state (G, I, Glu, GLP1, FFA)
// for the field cotangent gd: adds the state cotangents to dy and the
// effective-parameter cotangents to dP (pallas_rk4.py:553-602).
__device__ __forceinline__ void mech_t(float G, float I, float Glu, float GLP1,
                                       float FFA, const float* gd, const float* P,
                                       float* dy, float* dP, int stride) {
  const float gG = gd[0], gI = gd[1], gGlu = gd[2], gGLP = gd[3], gFFA = gd[5];
  const float Pi = 1.f + P[RHO] * GLP1;
  const float Gd = G - P[G_B];
  const float Glud = Glu - P[GLU_B];
  const float e_den = P[EC_50] + GLP1;
  const float glp1_eff = P[E_MAX] * GLP1 / e_den;
  const float km_den = P[K_M] + G;
  dy[0] += gI * (Pi * P[A_GI]) + gGLP * (P[V_MAX] * P[K_M] / (km_den * km_den)) +
           gFFA * (P[P_9] * FFA) - gG * P[K_GE0];
  dy[1] += -gI * P[K_I] - gFFA * (P[P_8] * FFA) - 0.01f * gG;
  dy[2] += -gGlu * glp1_eff + 0.005f * gG;
  dy[3] += gI * (P[RHO] * P[A_GI] * Gd) -
           gGlu * (Glud * P[E_MAX] * P[EC_50] / (e_den * e_den)) - gGLP * P[K_L];
  dy[5] += gFFA * (-P[P_7] - P[P_8] * I + P[P_9] * G);
  dP[A_GI * stride] += gI * Pi * Gd;
  dP[K_I * stride] -= gI * (I - P[I_B]);
  dP[RHO * stride] += gI * P[A_GI] * Gd * GLP1;
  dP[G_B * stride] -= gI * Pi * P[A_GI];
  dP[I_B * stride] += gI * P[K_I] + 0.01f * gG;
  dP[E_MAX * stride] -= gGlu * Glud * GLP1 / e_den;
  dP[EC_50 * stride] += gGlu * Glud * P[E_MAX] * GLP1 / (e_den * e_den);
  dP[GLU_B * stride] += gGlu * glp1_eff - 0.005f * gG;
  dP[V_MAX * stride] += gGLP * G / km_den;
  dP[K_M * stride] -= gGLP * P[V_MAX] * G / (km_den * km_den);
  dP[K_L * stride] -= gGLP * GLP1;
  dP[K_GE0 * stride] -= gG * G;
  dP[P_7 * stride] -= gFFA * FFA;
  dP[P_8 * stride] -= gFFA * I * FFA;
  dP[P_9 * stride] += gFFA * G * FFA;
}

size_t smem_bytes(int C, int in_pad, int H) {
  // X, dX [in_pad]; Ha, Hb [H]; R [NOUT]; P, dP [NP]; dY [4][NS]; dctx [C]
  return sizeof(float) * (size_t)(2 * in_pad + 2 * H + NOUT + 2 * NP + 4 * NS + C) * TILE;
}

// BF16: mlp_dtype='bf16', see fused_rk4_common.cuh.
template <bool BF16>
__global__ void __launch_bounds__(NTHREADS)
fused_rk4_bwd_kernel(const float* __restrict__ traj,  // (T, 6, B)
                     const float* __restrict__ gbar,  // (T, 6, B)
                     const float* __restrict__ ts,    // (T, B)
                     const float* __restrict__ meal,  // (T, B)
                     const float* __restrict__ tvns,  // (T, B)
                     const float* __restrict__ ctx,   // (C, B) or null
                     const float* __restrict__ wpack, // weights then biases
                     const float* __restrict__ pvec,  // (32,) PARAM_ORDER
                     const int* __restrict__ cidx,    // (n_cp,) or null
                     float* __restrict__ ybar0,       // (B, 6)
                     float* __restrict__ dp_out,      // (17, B)
                     float* __restrict__ dctx_out,    // (B, C) or null
                     float* __restrict__ partials,    // (gridDim.x, n_w)
                     float* __restrict__ scratch,     // (gridDim.x, 4 * substeps * stage)
                     int B, int T, int C, int in_pad, int H, int n_layers,
                     int substeps, int n_cp, int abs_mode, int n_w) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [in_pad][TILE] forward features
  float* dX = X + in_pad * TILE;               // [in_pad][TILE] their cotangent
  float* Ha = dX + in_pad * TILE;              // [H][TILE]
  float* Hb = Ha + H * TILE;                   // [H][TILE]
  float* R = Hb + H * TILE;                    // [NOUT][TILE] residual / stage cotangent
  float* Ps = R + NOUT * TILE;                 // [NP][TILE] effective parameters
  float* dPs = Ps + NP * TILE;                 // [NP][TILE] their cotangents
  float* dYs = dPs + NP * TILE;                // [4][NS][TILE] stage-state cotangents
  float* dCs = dYs + 4 * NS * TILE;            // [C][TILE] feature-mode context cotangent

  const int tid = threadIdx.x;
  const bool owner = tid < TILE;
  const int L = n_layers;
  const int stage = (in_pad + L * H) * TILE;  // floats saved per stage
  float* part = partials + (size_t)blockIdx.x * n_w;
  float* scr = scratch + (size_t)blockIdx.x * 4 * substeps * stage;
  const float* bias0 = wpack + in_pad * H + (L - 1) * H * H + H * NOUT;
  const int bias_off = in_pad * H + (L - 1) * H * H + H * NOUT;
  auto w_off = [&](int l) { return l == 0 ? 0 : in_pad * H + (l - 1) * H * H; };
  const float inv_s = 1.0f / (float)substeps;

  for (int i = tid; i < n_w; i += NTHREADS) part[i] = 0.f;

  const int n_tiles = (B + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile * TILE + tid;
    const bool valid = owner && b < B;

    for (int i = tid; i < in_pad * TILE; i += NTHREADS) X[i] = 0.f;
    for (int i = tid; i < C * TILE; i += NTHREADS) dCs[i] = 0.f;
    __syncthreads();
    float ybar[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) ybar[s] = 0.f;
    if (owner) {
      float P[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) P[p] = pvec[p];
      if (valid) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
          for (int r = 0; r < n_cp; ++r)
            if (cidx[r] == p) {
              const float c = ctx[r * B + b];
              P[p] = abs_mode ? c : P[p] * expf(c);
            }
        if (n_cp == 0)
          for (int r = 0; r < C; ++r) X[(NF + r) * TILE + tid] = ctx[r * B + b];
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = gbar[((T - 1) * NS + s) * B + b];
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        Ps[p * TILE + tid] = P[p];
        dPs[p * TILE + tid] = 0.f;
      }
    }
    __syncthreads();

    for (int iv = T - 2; iv >= 0; --iv) {
      float ts_l = 0.f, ts_r = 0.f, m_l = 0.f, m_r = 0.f, v_l = 0.f, v_r = 0.f;
      float y[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) y[s] = 0.f;
      if (valid) {
        ts_l = ts[iv * B + b];
        ts_r = ts[(iv + 1) * B + b];
        m_l = meal[iv * B + b];
        m_r = meal[(iv + 1) * B + b];
        v_l = tvns[iv * B + b];
        v_r = tvns[(iv + 1) * B + b];
#pragma unroll
        for (int s = 0; s < NS; ++s) y[s] = traj[(iv * NS + s) * B + b];
      }
      const float h = (ts_r - ts_l) * inv_s;

      // ---- forward pass over the interval, saving every stage ----
      for (int j = 0; j < substeps; ++j) {
        const float jf = (float)j;
        const float t = ts_l + jf * h;
        float k[NS], ksum[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) k[s] = ksum[s] = 0.f;
        for (int c = 0; c < 4; ++c) {
          float* st = scr + (size_t)(4 * j + c) * stage;
          if (owner) {
            const float off = c == 0 ? 0.f : (c == 3 ? h : 0.5f * h);
            const float alpha = c == 0 ? jf : (c == 3 ? jf + 1.0f : jf + 0.5f);
            const float tt = c == 0 ? t : t + off;
            float ys[NS], P[NP];
#pragma unroll
            for (int s = 0; s < NS; ++s) ys[s] = c == 0 ? y[s] : y[s] + off * k[s];
#pragma unroll
            for (int p = 0; p < NP; ++p) P[p] = Ps[p * TILE + tid];
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
          for (int i = tid; i < in_pad * SQ; i += NTHREADS)
            reinterpret_cast<float4*>(st)[i] = reinterpret_cast<const float4*>(X)[i];
          const float* w = wpack;
          const float* bias = bias0;
          const float* in = X;
          int K = in_pad;
          for (int l = 0; l < L; ++l) {
            float* dst = (l & 1) ? Hb : Ha;
            dense<BF16>(w, bias, in, dst, st + (in_pad + l * H) * TILE, K, H, true);
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

      // ---- reverse sweep: substeps backwards, stages 4, 3, 2, 1 ----
      for (int j = substeps - 1; j >= 0; --j) {
        float go[NS], dk[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          go[s] = ybar[s];
          dk[s] = (h / 6.0f) * go[s];
        }
        for (int c = 3; c >= 0; --c) {
          const float* st = scr + (size_t)(4 * j + c) * stage;
          auto act = [&](int l) { return st + (in_pad + l * H) * TILE; };
          if (owner) {
#pragma unroll
            for (int s = 0; s < NS; ++s) R[s * TILE + tid] = dk[s];
            R[6 * TILE + tid] = 0.f;
            R[7 * TILE + tid] = 0.f;
          }
          __syncthreads();
          // MLP transpose: g is the cotangent of the current layer's output
          const float* g = R;
          int N = NOUT;
          outer_acc<BF16>(part + w_off(L), part + bias_off + L * H, act(L - 1), g, H, NOUT);
          for (int l = L - 1; l >= 0; --l) {
            float* gz = (l & 1) ? Hb : Ha;
            dense_t<BF16>(wpack + w_off(l + 1), g, gz, act(l), H, N);
            __syncthreads();
            g = gz;
            N = H;
            outer_acc<BF16>(part + w_off(l), part + bias_off + l * H, l > 0 ? act(l - 1) : st, g,
                      l > 0 ? H : in_pad, H);
          }
          dense_t<BF16>(wpack, g, dX, nullptr, in_pad, H);
          __syncthreads();
          if (owner) {
            float P[NP], dy[NS];
#pragma unroll
            for (int p = 0; p < NP; ++p) P[p] = Ps[p * TILE + tid];
            dy[0] = dX[1 * TILE + tid];
            dy[1] = dX[2 * TILE + tid];
            dy[2] = dX[3 * TILE + tid];
            dy[3] = dX[4 * TILE + tid] + dX[7 * TILE + tid];
            dy[4] = dX[5 * TILE + tid];
            dy[5] = dX[6 * TILE + tid];
            if (n_cp == 0)
              for (int r = 0; r < C; ++r) dCs[r * TILE + tid] += dX[(NF + r) * TILE + tid];
            mech_t(st[1 * TILE + tid], st[2 * TILE + tid], st[3 * TILE + tid],
                   st[4 * TILE + tid], st[6 * TILE + tid], dk, P, dy, dPs + tid, TILE);
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              dYs[(c * NS + s) * TILE + tid] = dy[s];
              // next stage's cotangent: dk3 = h/3 go + h dY4, dk2 = h/3 go +
              // h/2 dY3, dk1 = h/6 go + h/2 dY2
              if (c == 3) dk[s] = (h / 3.0f) * go[s] + h * dy[s];
              else if (c == 2) dk[s] = (h / 3.0f) * go[s] + 0.5f * h * dy[s];
              else dk[s] = (h / 6.0f) * go[s] + 0.5f * h * dy[s];
            }
          }
        }
        if (owner) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            ybar[s] = go[s] + dYs[(0 * NS + s) * TILE + tid] + dYs[(1 * NS + s) * TILE + tid] +
                      dYs[(2 * NS + s) * TILE + tid] + dYs[(3 * NS + s) * TILE + tid];
        }
      }
      if (valid) {
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = ybar[s] + gbar[(iv * NS + s) * B + b];
      }
    }

    if (valid) {
#pragma unroll
      for (int s = 0; s < NS; ++s) ybar0[b * NS + s] = ybar[s];
      // params mode: closed-form fold of the effective-parameter cotangents
      for (int r = 0; r < n_cp; ++r) {
        const int p = cidx[r];
        const float d = dPs[p * TILE + tid];
        if (abs_mode) {
          dctx_out[b * C + r] = d;
          dPs[p * TILE + tid] = 0.f;
        } else {
          dctx_out[b * C + r] = d * Ps[p * TILE + tid];
          dPs[p * TILE + tid] = d * expf(ctx[r * B + b]);
        }
      }
      if (n_cp == 0)
        for (int r = 0; r < C; ++r) dctx_out[b * C + r] = dCs[r * TILE + tid];
      for (int p = 0; p < NP; ++p) dp_out[p * B + b] = dPs[p * TILE + tid];
    }
    __syncthreads();
  }
}

}  // namespace

// Number of blocks to launch: those that can be resident at once, at most
// one per 32-sample tile. The caller sizes `partials` and `scratch` by it.
extern "C" int fused_rk4_bwd_grid(int B, int C, int in_pad, int H, int bf16, int* grid) {
  const size_t smem = smem_bytes(C, in_pad, H);
  auto kernel = bf16 ? fused_rk4_bwd_kernel<true> : fused_rk4_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (B + TILE - 1) / TILE;
  *grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  return 0;
}

extern "C" int fused_rk4_bwd(const float* traj, const float* gbar, const float* ts,
                             const float* meal, const float* tvns, const float* ctx,
                             const float* wpack, const float* pvec, const int* cidx,
                             float* ybar0, float* dp, float* dctx, float* dflat,
                             float* partials, float* scratch, int B, int T, int C,
                             int in_pad, int H, int n_layers, int substeps, int n_cp,
                             int abs_mode, int bf16, int grid, int n_w, void* stream) {
  if (B < 1 || T < 1 || C < 0 || H < 4 || H % 4 != 0 || in_pad % 4 != 0 ||
      in_pad < NF + (n_cp ? 0 : C) || n_layers < 1 || substeps < 1 ||
      n_cp < 0 || n_cp > NP || (n_cp && n_cp != C) || (C && (!ctx || !dctx)) ||
      (n_cp && !cidx) || grid < 1 ||
      n_w != in_pad * H + (n_layers - 1) * H * H + H * NOUT + n_layers * H + NOUT ||
      (long long)T * NS * B > 0x7fffffffLL)  // int offsets
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, in_pad, H);
  auto kernel = bf16 ? fused_rk4_bwd_kernel<true> : fused_rk4_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, NTHREADS, smem, s>>>(
      traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0, dp, dctx, partials,
      scratch, B, T, C, in_pad, H, n_layers, substeps, n_cp, abs_mode, n_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(n_w + 255) / 256, 256, 0, s>>>(partials, grid, n_w, dflat);
  return (int)cudaGetLastError();
}
