// Fused reverse-time RK4 adjoint, second derivation, for Hopper (sm_90a).
//
// Replaces the TPU kernel `hybrid_ode_tpu/ops/pallas_rk4.py:_bwd_kernel`
// (every `bwd_impl` of `fused_rk4_hybrid` but 'hand'): the same function as
// fused_rk4_bwd.cu (ybar0, dflat, parameter and context cotangents of the
// discrete RK4 map of fused_rk4_fwd.cu), but with the transposes that
// reverse-mode differentiation of one RK4 substep generates, written here
// as a reverse sweep over the primitive operations of the field in the order
// the field performs them. It shares no cotangent code with fused_rk4_bwd.cu,
// so each guards the other; only the forward stage evaluation
// (fused_rk4_common.cuh) is common.
//
// Two schedules (argument `schedule`):
//   0 'recompute'  per interval one forward pass keeps only the state each
//                  substep starts from (shared memory); then, substeps backwards,
//                  each substep's four stages are evaluated again, saved, and
//                  transposed. Two forward passes per interval, scratch for
//                  one substep (4 stage slots). Parameter cotangents are
//                  reduced over the tile's samples inside the block (warp
//                  shuffles in a fixed butterfly, then a shared-memory row
//                  summed over the block's tiles in tile order) and leave as
//                  one (32,) row per block; `sum_rows` adds the rows in block
//                  order.
//   1 'chained'    per interval one forward pass that saves every stage of
//                  every substep (4 * substeps slots), then the reverse
//                  sweep. Parameter cotangents stay per sample, (17, B).
//
// Timing probes (`flags`, `fwd_passes`; the JAX package's probe_* modes; their
// gradients are partial by design and what they leave out is written as 0):
//   fwd_passes 1 | 2   that many forward passes per interval inside the
//                      adjoint's loop structure, no transposes
//   DIFF_W off         no weight / bias cotangents
//   DIFF_P off         no parameter / context cotangents
//   NO_MLP | NO_MECH   the field is only its mechanistic or only its MLP part
//
// What bounds it on an H100: arithmetic, as for fused_rk4_bwd.cu; 'recompute'
// does one more forward pass per interval than 'chained'.
//
// Design: the block structure is fused_rk4_bwd.cu's (one block per resident
// slot walks 32-sample tiles; thread tid < 32 owns a sample; weight
// cotangents go to the block's own slice of `partials`, summed in block order
// afterwards; saved activations go to the block's slice of global `scratch`).
// Per-sample parameter cotangents live in shared memory, not registers.
//
// Built with -fmad=false (hybrid_ode_torch/ops/fused_rk4.py), as the others.
// Interface: plain C functions taking device pointers and the stream, loaded
// with ctypes. They return cudaError_t.

#include "fused_rk4_common.cuh"

namespace {

using namespace fused_rk4;

enum { DIFF_W = 1, DIFF_P = 2, NO_MLP = 4, NO_MECH = 8 };

// Cotangent of a dense layer's input: out[k][s] = sum_n W[k][n] * g[n][s],
// times 1 where act[k][s] > 0 and 0 elsewhere when act is given (the ReLU
// that produced this layer's input). W is (K, N) row-major. A thread owns 4
// input rows x 4 samples. BF16: g is read rounded.
template <bool BF16>
__device__ __forceinline__ void input_cot(const float* __restrict__ W, const float* g,
                                          float* out, const float* act, int K, int N) {
  const int sq = threadIdx.x % SQ;
  const float4* g4 = reinterpret_cast<const float4*>(g) + sq;
  for (int kq = threadIdx.x / SQ; kq < K / 4; kq += NTHREADS / SQ) {
    float u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int s = 0; s < 4; ++s) u[i][s] = 0.f;
    for (int n = 0; n < N; n += 4) {
      float gv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = g4[(n + q) * SQ];
        gv[q][0] = operand<BF16>(a.x);
        gv[q][1] = operand<BF16>(a.y);
        gv[q][2] = operand<BF16>(a.z);
        gv[q][3] = operand<BF16>(a.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)(4 * kq + i) * N + n));
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) u[i][s] = fmaf(wv[q], gv[q][s], u[i][s]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = (4 * kq + i) * SQ + sq;
      if (act) {
        const float4 m = reinterpret_cast<const float4*>(act)[idx];
        u[i][0] = m.x > 0.f ? u[i][0] : 0.f * u[i][0];
        u[i][1] = m.y > 0.f ? u[i][1] : 0.f * u[i][1];
        u[i][2] = m.z > 0.f ? u[i][2] : 0.f * u[i][2];
        u[i][3] = m.w > 0.f ? u[i][3] : 0.f * u[i][3];
      }
      reinterpret_cast<float4*>(out)[idx] = make_float4(u[i][0], u[i][1], u[i][2], u[i][3]);
    }
  }
}

// Cotangent of a dense layer's weights and bias, added into this block's
// slice: dW[k][n] += sum_s a[k][s] * g[n][s], db[n] += sum_s g[n][s]. dW is
// (K, N) row-major. Which thread updates which element depends only on
// (K, N), so successive calls on one dW need no barrier between them.
// BF16: a and g are read rounded for the product; the bias sum takes g as it is.
template <bool BF16>
__device__ __forceinline__ void weight_cot(float* dW, float* db, const float* a,
                                           const float* g, int K, int N) {
  const int n4 = N / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int item = threadIdx.x; item < (K / 4) * n4; item += NTHREADS) {
    const int kq = item / n4, nq = item % n4;
    float d[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(dW + (size_t)(4 * kq + i) * N + 4 * nq);
      d[i][0] = v.x; d[i][1] = v.y; d[i][2] = v.z; d[i][3] = v.w;
    }
    for (int sq = 0; sq < SQ; ++sq) {
      float av[4][4], gv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = a4[(4 * kq + i) * SQ + sq];
        av[i][0] = operand<BF16>(x.x); av[i][1] = operand<BF16>(x.y);
        av[i][2] = operand<BF16>(x.z); av[i][3] = operand<BF16>(x.w);
        const float4 y = g4[(4 * nq + i) * SQ + sq];
        gv[i][0] = operand<BF16>(y.x); gv[i][1] = operand<BF16>(y.y);
        gv[i][2] = operand<BF16>(y.z); gv[i][3] = operand<BF16>(y.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int s = 0; s < 4; ++s) d[i][j] = fmaf(av[i][s], gv[j][s], d[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dW + (size_t)(4 * kq + i) * N + 4 * nq) =
          make_float4(d[i][0], d[i][1], d[i][2], d[i][3]);
  }
  for (int n = threadIdx.x; n < N; n += NTHREADS) {
    float s = 0.f;
    for (int j = 0; j < TILE; ++j) s += g[n * TILE + j];
    db[n] += s;
  }
}

// Reverse sweep over the mechanistic drift (`mech`, fused_rk4_common.cuh) at
// stage state y for the cotangent gd of its output: walks the drift's
// primitive operations backwards (dG, dFFA, dGLP1, dGlu, dI, then the shared
// differences), adding each operand's cotangent to yb (states) and, when pb
// is given, to pb (effective parameters).
__device__ __forceinline__ void mech_reverse(const float* y, const float* P,
                                             const float* gd, float* yb, float* pb) {
  const float G = y[0], I = y[1], Glu = y[2], GLP1 = y[3], FFA = y[5];
  const float gG = gd[0], gI = gd[1], gGlu = gd[2], gGLP = gd[3], gFFA = gd[5];
  float bG = 0.f, bI = 0.f, bGLP1 = 0.f, bFFA = 0.f;
  float bGd = 0.f, bId = 0.f, bGlud = 0.f;  // of G - G_b, I - I_b, Glu - Glu_b
  float bp[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) bp[p] = 0.f;

  // dG = meal - 0.01 Id + 0.005 Glud - k_GE0 G
  bG -= gG * P[K_GE0];
  bp[K_GE0] -= gG * G;
  bGlud += 0.005f * gG;
  bId -= 0.01f * gG;

  // dFFA = (-p_7) FFA - (p_8 I) FFA + (p_9 G) FFA
  {
    const float f2 = P[P_8] * I, f4 = P[P_9] * G;
    const float bf4 = gFFA * FFA;          // of p_9 G
    bFFA += gFFA * f4;
    bp[P_9] += bf4 * G;
    bG += bf4 * P[P_9];
    const float bf2 = -gFFA * FFA;         // of p_8 I
    bFFA -= gFFA * f2;
    bp[P_8] += bf2 * I;
    bI += bf2 * P[P_8];
    bp[P_7] -= gFFA * FFA;
    bFFA -= gFFA * P[P_7];
  }

  // dGLP1 = (V_max G) / (K_m + G) - k_L GLP1
  {
    bp[K_L] -= gGLP * GLP1;
    bGLP1 -= gGLP * P[K_L];
    const float vn = P[V_MAX] * G, vd = P[K_M] + G;
    const float bvn = gGLP / vd;           // x / y: x gets g / y,
    const float bvd = -(gGLP * vn) / (vd * vd);  // y gets -g x / y^2
    bp[V_MAX] += bvn * G;
    bG += bvn * P[V_MAX];
    bp[K_M] += bvd;
    bG += bvd;
  }

  // dGlu = -((E_max GLP1) / (EC_50 + GLP1)) Glud
  {
    const float Glud = Glu - P[GLU_B];
    const float en = P[E_MAX] * GLP1, ed = P[EC_50] + GLP1;
    const float ge = en / ed;
    bGlud -= gGlu * ge;
    const float bge = -(gGlu * Glud);
    const float ben = bge / ed;
    const float bed = -(bge * en) / (ed * ed);
    bp[E_MAX] += ben * GLP1;
    bGLP1 += ben * P[E_MAX];
    bp[EC_50] += bed;
    bGLP1 += bed;
  }

  // dI = ((1 + rho GLP1) a_GI) Gd - k_I Id
  {
    const float Id = I - P[I_B], Gd = G - P[G_B];
    bp[K_I] -= gI * Id;
    bId -= gI * P[K_I];
    const float Pi = 1.f + P[RHO] * GLP1;
    const float a1 = Pi * P[A_GI];
    const float ba1 = gI * Gd;             // of Pi a_GI
    bGd += gI * a1;
    const float bPi = ba1 * P[A_GI];
    bp[A_GI] += ba1 * Pi;
    bp[RHO] += bPi * GLP1;
    bGLP1 += bPi * P[RHO];
  }

  // the shared differences
  bG += bGd;
  bp[G_B] -= bGd;
  bI += bId;
  bp[I_B] -= bId;
  bp[GLU_B] -= bGlud;

  yb[0] += bG;
  yb[1] += bI;
  yb[2] += bGlud;
  yb[3] += bGLP1;
  yb[5] += bFFA;
  if (pb) {
#pragma unroll
    for (int p = 0; p < NP; ++p) pb[p] = bp[p];
  }
}

size_t smem_bytes(int C, int in_pad, int H, int substeps) {
  // X, dX [in_pad]; Ha, Hb [H]; R [NOUT]; P, dP [NP]; dctx [C];
  // substep input states [substeps][NS]; the block's parameter row [32]
  return sizeof(float) * ((size_t)(2 * in_pad + 2 * H + NOUT + 2 * NP + C +
                                   substeps * NS) * TILE + 32);
}

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS)
fused_rk4_bwd_vjp_kernel(const float* __restrict__ traj,  // (T, 6, B)
                         const float* __restrict__ gbar,  // (T, 6, B)
                         const float* __restrict__ ts,    // (T, B)
                         const float* __restrict__ meal,  // (T, B)
                         const float* __restrict__ tvns,  // (T, B)
                         const float* __restrict__ ctx,   // (C, B) or null
                         const float* __restrict__ wpack, // weights then biases
                         const float* __restrict__ pvec,  // (32,) PARAM_ORDER
                         const int* __restrict__ cidx,    // (n_cp,) or null
                         float* __restrict__ ybar0,       // (B, 6)
                         float* __restrict__ dp_out,      // (17, B), schedule 1
                         float* __restrict__ dpv_part,    // (gridDim.x, 32), schedule 0
                         float* __restrict__ dctx_out,    // (B, C) or null
                         float* __restrict__ partials,    // (gridDim.x, n_w)
                         float* __restrict__ scratch,     // (gridDim.x, slots * stage)
                         int B, int T, int C, int in_pad, int H, int n_layers,
                         int substeps, int n_cp, int abs_mode, int n_w,
                         int schedule, int flags, int fwd_passes) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [in_pad][TILE] forward features
  float* dX = X + in_pad * TILE;               // [in_pad][TILE] their cotangent
  float* Ha = dX + in_pad * TILE;              // [H][TILE]
  float* Hb = Ha + H * TILE;                   // [H][TILE]
  float* R = Hb + H * TILE;                    // [NOUT][TILE] residual / stage cotangent
  float* Ps = R + NOUT * TILE;                 // [NP][TILE] effective parameters
  float* dPs = Ps + NP * TILE;                 // [NP][TILE] base-parameter cotangents
  float* dCs = dPs + NP * TILE;                // [C][TILE] context cotangents
  float* Ys = dCs + C * TILE;                  // [substeps][NS][TILE] substep input states
  float* dpv_blk = Ys + substeps * NS * TILE;  // [32] this block's parameter row

  const int tid = threadIdx.x;
  const bool owner = tid < TILE;
  const int L = n_layers;
  const bool recompute = schedule == 0;
  const bool diff_w = flags & DIFF_W, diff_p = flags & DIFF_P;
  const bool use_mlp = !(flags & NO_MLP), use_mech = !(flags & NO_MECH);
  const int stage = (in_pad + L * H) * TILE;  // floats saved per stage
  const int slots = recompute ? 4 : 4 * substeps;
  float* part = partials + (size_t)blockIdx.x * n_w;
  float* scr = scratch + (size_t)blockIdx.x * slots * stage;
  const int bias_off = in_pad * H + (L - 1) * H * H + H * NOUT;
  auto w_off = [&](int l) { return l == 0 ? 0 : in_pad * H + (l - 1) * H * H; };
  const float inv_s = 1.0f / (float)substeps;

  for (int i = tid; i < n_w; i += NTHREADS) part[i] = 0.f;
  if (tid < 32) dpv_blk[tid] = 0.f;

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

      // One RK4 substep forward from y (updated in place), the arithmetic of
      // fused_rk4_fwd.cu; with `save` every stage's features and activations
      // go to save + c * stage.
      auto forward_substep = [&](int j, float* save) {
        const float jf = (float)j;
        const float t = ts_l + jf * h;
        float k[NS], ksum[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) k[s] = ksum[s] = 0.f;
        for (int c = 0; c < 4; ++c) {
          float* st = save ? save + (size_t)c * stage : nullptr;
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
            if (use_mech) {
              mech(ys, m, P, k);
            } else {
#pragma unroll
              for (int s = 0; s < NS; ++s) k[s] = 0.f;
            }
          }
          __syncthreads();
          if (st)
            for (int i = tid; i < in_pad * SQ; i += NTHREADS)
              reinterpret_cast<float4*>(st)[i] = reinterpret_cast<const float4*>(X)[i];
          if (use_mlp) {
            const float* w = wpack;
            const float* bias = wpack + bias_off;
            const float* in = X;
            int K = in_pad;
            for (int l = 0; l < L; ++l) {
              float* dst = (l & 1) ? Hb : Ha;
              dense<BF16>(w, bias, in, dst, st ? st + (in_pad + l * H) * TILE : nullptr, K, H,
                          true);
              __syncthreads();
              w += K * H;
              bias += H;
              in = dst;
              K = H;
            }
            dense<BF16>(w, bias, in, R, nullptr, K, NOUT, false);
          }
          __syncthreads();
          if (owner) {
            const float wgt = (c == 1 || c == 2) ? 2.0f : 1.0f;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              if (use_mlp) k[s] += R[s * TILE + tid];
              ksum[s] = c == 0 ? k[s] : ksum[s] + wgt * k[s];
            }
          }
        }
        if (owner) {
          const float h6 = h / 6.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) y[s] = y[s] + h6 * ksum[s];
        }
      };

      // Reverse sweep over one substep whose stages were saved at `saved`:
      // ybar, the cotangent of the substep's output, becomes that of its
      // input. From Y' = Y + (h/6)(k1 + 2 k2 + 2 k3 + k4), k2 = f(Y + h/2 k1),
      // k3 = f(Y + h/2 k2), k4 = f(Y + h k3): the k's get (h/6) ybar times
      // their weights, and walking k4 .. k1 each stage's state cotangent is
      // added to Y's and, scaled by the stage's step fraction, to the k
      // before it.
      auto reverse_substep = [&](const float* saved) {
        float go[NS], acc[NS], dk[NS];
        const float h6 = h / 6.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          go[s] = h6 * ybar[s];  // cotangent of the weighted sum of the k's
          acc[s] = ybar[s];      // Y' = Y + ...: Y gets ybar
          dk[s] = go[s];         // k4
        }
        for (int c = 3; c >= 0; --c) {
          const float* st = saved + (size_t)c * stage;
          auto act = [&](int l) { return st + (in_pad + l * H) * TILE; };
          if (use_mlp) {
            if (owner) {
#pragma unroll
              for (int s = 0; s < NS; ++s) R[s * TILE + tid] = dk[s];
              R[6 * TILE + tid] = 0.f;
              R[7 * TILE + tid] = 0.f;
            }
            __syncthreads();
            // through the layers backwards: g is the cotangent of the
            // current layer's pre-activation output
            const float* g = R;
            int N = NOUT;
            for (int l = L; l >= 0; --l) {
              const float* in = l > 0 ? act(l - 1) : st;
              const int K = l > 0 ? H : in_pad;
              if (diff_w)
                weight_cot<BF16>(part + w_off(l), part + bias_off + l * H, in, g, K, N);
              float* u = l == 0 ? dX : ((l & 1) ? Ha : Hb);
              input_cot<BF16>(wpack + w_off(l), g, u, l > 0 ? in : nullptr, K, N);
              __syncthreads();
              g = u;
              N = H;
            }
          }
          if (owner) {
            float yb[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s) yb[s] = 0.f;
            if (use_mlp) {
              // features X = [t, y(6), GLP1, tVNS, context...]
#pragma unroll
              for (int s = 0; s < NS; ++s) yb[s] = dX[(1 + s) * TILE + tid];
              yb[3] += dX[7 * TILE + tid];
              if (diff_p && n_cp == 0)
                for (int r = 0; r < C; ++r) dCs[r * TILE + tid] += dX[(NF + r) * TILE + tid];
            }
            if (use_mech) {
              float P[NP], pb[NP], ys[NS];
#pragma unroll
              for (int p = 0; p < NP; ++p) P[p] = Ps[p * TILE + tid];
#pragma unroll
              for (int s = 0; s < NS; ++s) ys[s] = st[(1 + s) * TILE + tid];
              mech_reverse(ys, P, dk, yb, diff_p ? pb : nullptr);
              if (diff_p) {
                // effective parameter -> base parameter and context row:
                // 'mul' P = base * e^c, 'abs' P = c
                bool conditioned[NP];
#pragma unroll
                for (int p = 0; p < NP; ++p) conditioned[p] = false;
                for (int r = 0; r < n_cp; ++r) {
#pragma unroll
                  for (int p = 0; p < NP; ++p)
                    if (cidx[r] == p) {
                      conditioned[p] = true;
                      if (abs_mode) {
                        dCs[r * TILE + tid] += pb[p];
                      } else {
                        const float e = valid ? expf(ctx[r * B + b]) : 1.f;
                        dPs[p * TILE + tid] += pb[p] * e;
                        dCs[r * TILE + tid] += (pb[p] * pvec[p]) * e;
                      }
                    }
                }
#pragma unroll
                for (int p = 0; p < NP; ++p)
                  if (!conditioned[p]) dPs[p * TILE + tid] += pb[p];
              }
            }
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              acc[s] += yb[s];
              // the k before this stage's: k3 weighs 2 and feeds k4 by h,
              // k2 weighs 2 and feeds k3 by h/2, k1 weighs 1 and feeds k2 by h/2
              if (c == 3) dk[s] = 2.0f * go[s] + h * yb[s];
              else if (c == 2) dk[s] = 2.0f * go[s] + (0.5f * h) * yb[s];
              else dk[s] = go[s] + (0.5f * h) * yb[s];
            }
          }
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = acc[s];
      };

      // forward: one pass ('chained' saves every stage, 'recompute' only the
      // substep states); a timing probe makes fwd_passes passes, none saved,
      // each chained to the last so that none can be dropped
      const bool probe_fwd = fwd_passes > 0;
      const float y_left[NS] = {y[0], y[1], y[2], y[3], y[4], y[5]};
      float last[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) last[s] = y[s];
      for (int pass = 0; pass < (probe_fwd ? fwd_passes : 1); ++pass) {
        if (probe_fwd) {
#pragma unroll
          for (int s = 0; s < NS; ++s) y[s] = y_left[s] + 1e-30f * last[s];
        }
        for (int j = 0; j < substeps; ++j) {
          if (recompute && owner) {
#pragma unroll
            for (int s = 0; s < NS; ++s) Ys[(j * NS + s) * TILE + tid] = y[s];
          }
          forward_substep(j, (probe_fwd || recompute) ? nullptr : scr + (size_t)4 * j * stage);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) last[s] = y[s];
      }
      if (probe_fwd) {
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = ybar[s] + 1e-30f * last[s];
      } else {
        for (int j = substeps - 1; j >= 0; --j) {
          if (recompute) {  // this substep's stages again, from its saved state
            if (owner) {
#pragma unroll
              for (int s = 0; s < NS; ++s) y[s] = Ys[(j * NS + s) * TILE + tid];
            }
            forward_substep(j, scr);
          }
          reverse_substep(recompute ? scr : scr + (size_t)4 * j * stage);
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
      for (int r = 0; r < C; ++r) dctx_out[b * C + r] = dCs[r * TILE + tid];
      if (!recompute)
        for (int p = 0; p < NP; ++p) dp_out[p * B + b] = dPs[p * TILE + tid];
    }
    if (recompute && owner) {
      // the tile's samples, summed by a fixed butterfly over the warp's lanes
      for (int p = 0; p < NP; ++p) {
        float v = valid ? dPs[p * TILE + tid] : 0.f;
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        if (tid == 0) dpv_blk[p] += v;
      }
    }
    __syncthreads();
  }
  if (recompute && tid < 32) dpv_part[blockIdx.x * 32 + tid] = dpv_blk[tid];
}

}  // namespace

// Number of blocks to launch: those that can be resident at once, at most
// one per 32-sample tile. The caller sizes `partials`, `dpv_part` and
// `scratch` by it.
extern "C" int fused_rk4_bwd_vjp_grid(int B, int C, int in_pad, int H, int substeps,
                                      int bf16, int* grid) {
  if (B < 1 || C < 0 || in_pad < 1 || H < 1 || substeps < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, in_pad, H, substeps);
  auto kernel = bf16 ? fused_rk4_bwd_vjp_kernel<true> : fused_rk4_bwd_vjp_kernel<false>;
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

// Samples per block tile: the caller sizes a scratch slot by it.
extern "C" int fused_rk4_bwd_vjp_tile(int* tile) {
  *tile = TILE;
  return 0;
}

// schedule 0: dpv (32,) and dpv_part (grid, 32) are written, dp is not read;
// schedule 1: dp (17, B) is written, dpv and dpv_part are not read.
extern "C" int fused_rk4_bwd_vjp(const float* traj, const float* gbar, const float* ts,
                                 const float* meal, const float* tvns, const float* ctx,
                                 const float* wpack, const float* pvec, const int* cidx,
                                 float* ybar0, float* dp, float* dpv, float* dpv_part,
                                 float* dctx, float* dflat, float* partials, float* scratch,
                                 int B, int T, int C, int in_pad, int H, int n_layers,
                                 int substeps, int n_cp, int abs_mode, int bf16, int grid,
                                 int n_w, int schedule, int flags, int fwd_passes,
                                 void* stream) {
  if (B < 1 || T < 1 || C < 0 || H < 4 || H % 4 != 0 || in_pad % 4 != 0 ||
      in_pad < NF + (n_cp ? 0 : C) || n_layers < 1 || substeps < 1 ||
      n_cp < 0 || n_cp > NP || (n_cp && n_cp != C) || (C && (!ctx || !dctx)) ||
      (n_cp && !cidx) || grid < 1 || schedule < 0 || schedule > 1 ||
      flags < 0 || flags > 15 || fwd_passes < 0 || fwd_passes > 2 ||
      (schedule == 0 && (!dpv || !dpv_part)) || (schedule == 1 && !dp) ||
      n_w != in_pad * H + (n_layers - 1) * H * H + H * NOUT + n_layers * H + NOUT ||
      (long long)T * NS * B > 0x7fffffffLL)  // int offsets
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, in_pad, H, substeps);
  auto kernel = bf16 ? fused_rk4_bwd_vjp_kernel<true> : fused_rk4_bwd_vjp_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, NTHREADS, smem, s>>>(
      traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0, dp, dpv_part, dctx,
      partials, scratch, B, T, C, in_pad, H, n_layers, substeps, n_cp, abs_mode, n_w,
      schedule, flags, fwd_passes);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(n_w + 255) / 256, 256, 0, s>>>(partials, grid, n_w, dflat);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (schedule == 0) {
    sum_rows<<<1, 32, 0, s>>>(dpv_part, grid, 32, dpv);
    err = cudaGetLastError();
  }
  return (int)err;
}
