// Fused reverse-time RK4 adjoint, second derivation, for Hopper (sm_90a).
//
// Replaces the TPU kernel `hybrid_ode_tpu/ops/pallas_rk4.py:_bwd_kernel`
// (every `bwd_impl` of `fused_rk4_hybrid` but 'hand'): the same function as
// fused_rk4_bwd.cu (ybar0, dflat, parameter and context cotangents of the
// discrete RK4 map of fused_rk4_fwd.cu), but with the transposes that
// reverse-mode differentiation of one RK4 substep generates, written here
// as a reverse sweep over the primitive operations of the field in the order
// the field performs them. It shares no cotangent code with fused_rk4_bwd.cu
// (not its transposed weight copy, its ReLU-mask bits or its weight-cotangent
// routine), so each guards the other; only the forward stage evaluation
// (`dense_w`, `dense_out`, `mech`) and the weight staging (`Ring`) are common.
//
// Two schedules (argument `schedule`):
//   0 'recompute'  per interval one forward pass keeps only the state each
//                  substep starts from (shared memory); then, substeps backwards,
//                  each substep's four stages are evaluated again, saved, and
//                  transposed. Two forward passes per interval, scratch for
//                  one substep (4 stage slots). Parameter cotangents are
//                  reduced over the tile's samples inside the block (warp
//                  shuffles in a fixed butterfly over each of the two owner
//                  warps, the two warp sums added in warp order, then a
//                  shared-memory row summed over the block's tiles in tile
//                  order) and leave as one (32,) row per block; `sum_rows`
//                  adds the rows in block order.
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
// What bounds it on an H100: arithmetic, as for fused_rk4_bwd.cu (about
// 2.5e12 FLOP at the cohort shape, 38 ms at the 67 TFLOP/s f32 CUDA-core
// peak); 'recompute' does one more forward pass per interval than 'chained'.
//
// Design:
//   * 64-sample tiles (WTILE), one block per SM, the cohort one wave; thread
//     tid < WTILE owns a sample: its RK4 cotangents live in registers, its
//     parameters and parameter / context cotangents in shared memory.
//   * MLP weights staged layer by layer in shared memory through the two
//     buffers of fused_rk4_wide.cuh: layers 0 .. L for every forward stage,
//     L .. 0 for every reverse stage, each prefetched by cp.async while the
//     layer before it multiplies. The forward products are dense_w /
//     dense_out, so every pre-activation and ReLU mask is bitwise the
//     forward kernel's. The transposed products are this file's `input_cot`,
//     which reads the staged (K, N) layer as it is: a thread owns 8 (or 4)
//     input rows x 4 samples and reads each row's weights as float4 along n.
//   * Weight cotangents once per substep: every stage saves its MLP inputs
//     and activations (forward) and each layer's output cotangent (reverse)
//     in its slot of the block's scratch; after a substep's four stages,
//     `substep_weight_cot` contracts each layer over the 4 x 64 columns,
//     streaming them through the two buffers in chunks, with an 8 x 8 (or
//     4 x 4) register tile per thread, and adds the result to the block's
//     slice of `partials` once per substep and layer.
//   * Across blocks: block g owns partials[g] (and, 'recompute', dpv_part[g]);
//     `sum_rows` adds the slices in block order. No atomics: two launches on
//     the same inputs give bitwise equal outputs.
//   * Route `staged`: taken when the two weight buffers fit beside the
//     activations; otherwise the same products read the weights from global
//     memory and only the contraction's chunks pass through what is left.
//   The library reports tile, grid, scratch, partials, route and shared
//   memory (`fused_rk4_bwd_vjp_sizes`).
//
// mlp_dtype='bf16' is the template argument BF16: every product's operands are
// rounded to bf16 at the load (the weights arrive rounded); bias sums, masks
// and accumulators stay f32.
//
// Built with -fmad=false (hybrid_ode_torch/ops/fused_rk4.py), as the others.
// Interface: plain C functions taking device pointers and the stream, loaded
// with ctypes. They return cudaError_t.

#include "fused_rk4_wide.cuh"

namespace {

using namespace fused_rk4;

enum { DIFF_W = 1, DIFF_P = 2, NO_MLP = 4, NO_MECH = 8 };

// Cotangent of a dense layer's input: u[k][s] = sum_n W[k][n] * g[n][s] for
// k < K, n ascending, times 1 where act[k][s] > 0 and 0 elsewhere when act is
// given (the ReLU that produced this layer's input); also stored to gsave
// when given. W is the layer as staged for the forward product, (K, N)
// row-major; g, u, act and gsave are [rows][WTILE]. A thread owns RK rows
// k0 .. k0 + RK x 4 samples and per 4 n reads RK float4 of weights (one per
// row; the lanes that share rows read one address) and 4 of g.
// The mask: before the product every thread starts copying the elements of
// act it will need (those of its own tiles) into the same places of u, as one
// cp.async group; then `fetch()` may start the next layer's weights (and
// says whether it committed a group); the epilogue waits for the older group
// only, so the activations, which come from scratch, arrive during the
// product and cost no registers. BF16: g is read rounded.
template <bool BF16, int RK, class Fetch>
__device__ __forceinline__ void input_cot(const float* W, const float* g, float* u,
                                          const float* act, float* gsave, int K, int N,
                                          Fetch fetch) {
  const int n4 = N / 4;
  const int tiles = (K / RK) * WSQ;
  if (act) {
    for (int t = threadIdx.x; t < tiles; t += NTHREADS) {
      const int sq = t % WSQ, k0 = (t / WSQ) * RK;
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int e = 4 * ((k0 + i) * WSQ + sq);
        __pipeline_memcpy_async(u + e, act + e, 16);
      }
    }
    __pipeline_commit();
  }
  const bool newer = fetch();
  for (int t = threadIdx.x; t < tiles; t += NTHREADS) {
    const int sq = t % WSQ, k0 = (t / WSQ) * RK;
    const float4* w4 = reinterpret_cast<const float4*>(W) + (size_t)k0 * n4;
    const float4* g4 = reinterpret_cast<const float4*>(g) + sq;
    float acc[RK][4];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[i][s] = 0.f;
#pragma unroll 2
    for (int nq = 0; nq < n4; ++nq) {
      float gv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = g4[(4 * nq + q) * WSQ];
        gv[q][0] = operand<BF16>(a.x); gv[q][1] = operand<BF16>(a.y);
        gv[q][2] = operand<BF16>(a.z); gv[q][3] = operand<BF16>(a.w);
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float4 w = w4[i * n4 + nq];
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[i][s] = fmaf(wv[q], gv[q][s], acc[i][s]);
      }
    }
    if (act) {
      if (newer) __pipeline_wait_prior(1);
      else __pipeline_wait_prior(0);
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int idx = (k0 + i) * WSQ + sq;
      if (act) {
        const float4 m = reinterpret_cast<const float4*>(u)[idx];
        acc[i][0] = m.x > 0.f ? acc[i][0] : 0.f * acc[i][0];
        acc[i][1] = m.y > 0.f ? acc[i][1] : 0.f * acc[i][1];
        acc[i][2] = m.z > 0.f ? acc[i][2] : 0.f * acc[i][2];
        acc[i][3] = m.w > 0.f ? acc[i][3] : 0.f * acc[i][3];
      }
      const float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(u)[idx] = o;
      if (gsave) reinterpret_cast<float4*>(gsave)[idx] = o;
    }
  }
}

template <bool BF16, class Fetch>
__device__ __forceinline__ void input_cot_any(const float* W, const float* g, float* u,
                                              const float* act, float* gsave, int K, int N,
                                              Fetch fetch) {
  if (K % 8 == 0 && (K / 8) * WSQ >= NTHREADS)
    input_cot<BF16, 8>(W, g, u, act, gsave, K, N, fetch);
  else
    input_cot<BF16, 4>(W, g, u, act, gsave, K, N, fetch);
}

// One substep's weight and bias cotangents of one layer, added into this
// block's slice: D[k][n] += sum_col A[k][col] * G[n][col] for k < K, n < N
// (D row-major (K, N)) and Db[n] += sum_col G[n][col], over the WTILE columns
// of each of the substep's 4 stage slots (A, G: stage 0's rows, [row][WTILE];
// stage c at + c * slot). The columns pass through the ring in chunks of cc,
// rows padded to cc + 4 floats. A thread owns the TK rows ka, ka + K / TK, ...
// of A (neighbouring lanes, neighbouring rows: four banks apart) and the TN
// rows nb * TN .. of G (read by every lane of its group at one address), so
// its tile of D is TK rows x TN contiguous columns, added as float4. Columns
// are taken in ascending order; every element of D and Db always belongs to
// the same thread. BF16: both operands are read rounded; Db takes G as it is.
template <bool BF16, int TK, int TN>
__device__ __forceinline__ void substep_weight_cot(float* D, float* Db, const float* A,
                                                   const float* G, long long slot, int K,
                                                   int N, Ring& ring) {
  const int tid = threadIdx.x;
  const int tiles_k = K / TK, tiles = tiles_k * (N / TN);
  int cc = WTILE;
  while (cc > 4 && (K + N) * (cc + 4) > ring.cap) cc /= 2;
  const int ld = cc + 4, cq = cc / 4, per_stage = WTILE / cc, n_chunks = 4 * per_stage;
  auto load = [&](int ch) {
    float* a_dst = ring.incoming();
    float* g_dst = a_dst + K * ld;
    const long long off = (ch / per_stage) * slot + (ch % per_stage) * cc;
    for (int i = tid; i < (K + N) * cq; i += NTHREADS) {
      const int r = i / cq, q = i % cq;
      const float* src = r < K ? A + off + (size_t)r * WTILE : G + off + (size_t)(r - K) * WTILE;
      __pipeline_memcpy_async((r < K ? a_dst + r * ld : g_dst + (r - K) * ld) + 4 * q,
                              src + 4 * q, 16);
    }
    ring.commit();
  };
  for (int t0 = 0; t0 < tiles; t0 += NTHREADS) {
    const int t = t0 + tid;
    const bool active = t < tiles;
    const int ka = active ? t % tiles_k : 0, nb = active ? t / tiles_k : 0;
    float acc[TK][TN];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float bsum[2] = {0.f, 0.f};  // Db of rows tid and tid + NTHREADS (N <= 2 NTHREADS)
    load(0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const float* As = ring.arrive();
      const float* Gs = As + K * ld;
      if (ch + 1 < n_chunks) load(ch + 1);
      if (active) {
        const float4* a4 = reinterpret_cast<const float4*>(As) + ka * (ld / 4);
        const float4* g4 = reinterpret_cast<const float4*>(Gs) + nb * TN * (ld / 4);
#pragma unroll 2
        for (int c4 = 0; c4 < cq; ++c4) {
          float av[TK][4], gv[TN][4];
#pragma unroll
          for (int i = 0; i < TK; ++i) {
            const float4 a = a4[i * tiles_k * (ld / 4) + c4];
            av[i][0] = operand<BF16>(a.x); av[i][1] = operand<BF16>(a.y);
            av[i][2] = operand<BF16>(a.z); av[i][3] = operand<BF16>(a.w);
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float4 g = g4[j * (ld / 4) + c4];
            gv[j][0] = operand<BF16>(g.x); gv[j][1] = operand<BF16>(g.y);
            gv[j][2] = operand<BF16>(g.z); gv[j][3] = operand<BF16>(g.w);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int i = 0; i < TK; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i][c], gv[j][c], acc[i][j]);
        }
      }
      if (t0 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = tid + r * NTHREADS;
          if (n < N) {
            float s = 0.f;
            for (int c = 0; c < cc; ++c) s += Gs[n * ld + c];
            bsum[r] += s;
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        float4* d4 = reinterpret_cast<float4*>(D + (size_t)(ka + i * tiles_k) * N + nb * TN);
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          float4 d = d4[q];
          d.x += acc[i][4 * q]; d.y += acc[i][4 * q + 1];
          d.z += acc[i][4 * q + 2]; d.w += acc[i][4 * q + 3];
          d4[q] = d;
        }
      }
    }
    if (t0 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (tid + r * NTHREADS < N) Db[tid + r * NTHREADS] += bsum[r];
    }
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

// What a launch needs besides its arguments, from the widths alone.
struct Layout {
  size_t smem;              // bytes of dynamic shared memory
  int cap;                  // floats of one ring buffer
  int staged;               // weights through shared memory
  int rt;                   // rows per thread tile of an H-wide forward product
  long long slot;           // floats of one stage slot of scratch
  long long scratch;        // floats of a block's scratch slice
};

// 0 when the widths fit a block's shared memory.
int vjp_layout(int C, int in_pad, int H, int L, int substeps, int schedule, Layout* lay) {
  const int hb = H > in_pad ? H : in_pad;
  // X [in_pad]; Ha [H]; Hb = dX [max(H, in_pad)]; R [NOUT]; P, dP [NP]; dctx [C];
  // 'recompute': substep input states [substeps][NS]; the block's parameter row [32]
  const size_t acts = sizeof(float) * ((size_t)WTILE * (in_pad + H + hb + NOUT + 2 * NP + C +
                                                        (schedule == 0 ? substeps * NS : 0)) +
                                       32);
  if (acts >= (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const size_t left = (size_t)SMEM_LIMIT - acts;
  // the contraction's largest layer in chunks of 4 columns (padded to 8); unstaged,
  // at most chunks of 32 (padded to 36), and the rest of the SM's memory stays L1
  const int kn = hb + H;
  const int chunk_min = 8 * kn, chunk_max = 36 * kn;
  const int wcap = max_layer_floats(in_pad, H, L);
  const int want = wcap > chunk_min ? wcap : chunk_min;
  lay->staged = 2 * sizeof(float) * (size_t)want <= left;
  lay->cap = lay->staged ? want : (int)(left / (2 * sizeof(float)) / 4 * 4);
  if (!lay->staged && lay->cap > chunk_max) lay->cap = chunk_max;
  if (lay->cap < chunk_min) return (int)cudaErrorInvalidValue;
  lay->smem = acts + 2 * sizeof(float) * (size_t)lay->cap;
  lay->rt = (H / 8) * WSQ >= NTHREADS ? 8 : 4;
  lay->slot = (long long)WTILE * (in_pad + 2 * L * H + NOUT);
  lay->scratch = (schedule == 0 ? 4LL : 4LL * substeps) * lay->slot;
  return 0;
}

// BF16: mlp_dtype='bf16'; RT: rows per thread tile of an H-wide forward
// product; STAGED: MLP weights through shared memory (fused_rk4_wide.cuh).
template <bool BF16, int RT, bool STAGED>
__global__ void __launch_bounds__(NTHREADS, 1)
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
                         float* __restrict__ scratch,     // (gridDim.x, slots * slot)
                         int B, int T, int C, int in_pad, int H, int n_layers,
                         int substeps, int n_cp, int abs_mode, int n_w,
                         int schedule, int flags, int fwd_passes, int cap, long long slot) {
  const bool recompute = schedule == 0;
  const int hb = H > in_pad ? H : in_pad;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [in_pad][WTILE] forward features
  float* Ha = X + in_pad * WTILE;              // [H][WTILE]
  float* Hb = Ha + H * WTILE;                  // [hb][WTILE]
  // the features' cotangent: the layer-0 transpose reads Ha, so Hb is free
  float* dX = Hb;                              // [in_pad][WTILE]
  float* R = Hb + hb * WTILE;                  // [NOUT][WTILE] residual / stage cotangent
  float* Ps = R + NOUT * WTILE;                // [NP][WTILE] effective parameters
  float* dPs = Ps + NP * WTILE;                // [NP][WTILE] base-parameter cotangents
  float* dCs = dPs + NP * WTILE;               // [C][WTILE] context cotangents
  float* Ys = dCs + C * WTILE;                 // [substeps][NS][WTILE], 'recompute'
  float* dpv_blk = Ys + (recompute ? substeps * NS * WTILE : 0);  // [32] parameter row
  Ring ring;
  ring.init(dpv_blk + 32, cap);                // [2][cap]

  const int tid = threadIdx.x;
  const bool owner = tid < WTILE;
  const int L = n_layers;
  const bool diff_w = flags & DIFF_W, diff_p = flags & DIFF_P;
  const bool use_mlp = !(flags & NO_MLP), use_mech = !(flags & NO_MECH);
  const int slots = recompute ? 4 : 4 * substeps;
  const int rows_a = in_pad + L * H;           // a slot's rows of MLP inputs, then
                                               // L * H + NOUT rows of output cotangents
  float* part = partials + (size_t)blockIdx.x * n_w;
  float* scr = scratch + (size_t)blockIdx.x * slots * slot;
  const int bias_off = layer_offset(L, in_pad, H) + H * NOUT;
  const float* bias0 = wpack + bias_off;
  auto w_src = [&](int l) { return wpack + layer_offset(l, in_pad, H); };
  auto w_n = [&](int l) { return layer_floats(l, in_pad, H, L); };
  auto gbuf = [&](int l) { return (l & 1) ? Hb : Ha; };  // layer l's output
  const float inv_s = 1.0f / (float)substeps;

  for (int i = tid; i < n_w; i += NTHREADS) part[i] = 0.f;
  if (tid < 32) dpv_blk[tid] = 0.f;

  const int n_tiles = (B + WTILE - 1) / WTILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile * WTILE + tid;
    const bool valid = owner && b < B;

    for (int i = tid; i < in_pad * WTILE; i += NTHREADS) X[i] = 0.f;
    for (int i = tid; i < C * WTILE; i += NTHREADS) dCs[i] = 0.f;
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
          for (int r = 0; r < C; ++r) X[(NF + r) * WTILE + tid] = ctx[r * B + b];
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = gbar[((T - 1) * NS + s) * B + b];
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        Ps[p * WTILE + tid] = P[p];
        dPs[p * WTILE + tid] = 0.f;
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

      // Substeps j0 .. j1 - 1 forward from y (updated in place), the
      // arithmetic of fused_rk4_fwd.cu. With `save` stage c of substep j keeps
      // its features and activations in slot 4 (j - j0) + c from `save`; with
      // `keep_y` each substep's input state goes to Ys. The pass fetches its
      // first layer and leaves no fetch behind.
      auto forward = [&](int j0, int j1, float* save, bool keep_y) {
        if (use_mlp) fetch_weights<STAGED>(ring, w_src(0), w_n(0));
        for (int j = j0; j < j1; ++j) {
          if (keep_y && owner) {
#pragma unroll
            for (int s = 0; s < NS; ++s) Ys[(j * NS + s) * WTILE + tid] = y[s];
          }
          const float jf = (float)j;
          const float t = ts_l + jf * h;
          float k[NS], ksum[NS];
#pragma unroll
          for (int s = 0; s < NS; ++s) k[s] = ksum[s] = 0.f;
          for (int c = 0; c < 4; ++c) {
            float* st = save ? save + (size_t)(4 * (j - j0) + c) * slot : nullptr;
            if (owner) {
              const float off = c == 0 ? 0.f : (c == 3 ? h : 0.5f * h);
              const float alpha = c == 0 ? jf : (c == 3 ? jf + 1.0f : jf + 0.5f);
              const float tt = c == 0 ? t : t + off;
              float ys[NS], P[NP];
#pragma unroll
              for (int s = 0; s < NS; ++s) ys[s] = c == 0 ? y[s] : y[s] + off * k[s];
#pragma unroll
              for (int p = 0; p < NP; ++p) P[p] = Ps[p * WTILE + tid];
              const float a = alpha * inv_s;
              const float m = m_l + (m_r - m_l) * a;
              const float v = v_l + (v_r - v_l) * a;
              X[tid] = tt;
#pragma unroll
              for (int s = 0; s < NS; ++s) X[(1 + s) * WTILE + tid] = ys[s];
              X[7 * WTILE + tid] = ys[3];
              X[8 * WTILE + tid] = v;
              if (use_mech) {
                mech(ys, m, P, k);
              } else {
#pragma unroll
                for (int s = 0; s < NS; ++s) k[s] = 0.f;
              }
            }
            auto save_x = [&]() {  // X is complete behind a barrier
              if (st)
                for (int e = tid; e < in_pad * WSQ; e += NTHREADS)
                  reinterpret_cast<float4*>(st)[e] = reinterpret_cast<const float4*>(X)[e];
            };
            if (use_mlp) {
              const float* in = X;
              int K = in_pad;
              for (int l = 0; l < L; ++l) {
                const float* W = weights_ready<STAGED>(ring, w_src(l));
                fetch_weights<STAGED>(ring, w_src(l + 1), w_n(l + 1));
                if (l == 0) save_x();
                float* dst = gbuf(l);
                const float* bias = bias0 + l * H;
                float* st_l = st ? st + (size_t)(in_pad + l * H) * WTILE : nullptr;
                dense_w<BF16, RT>(W, in, K, H, NoTag(),
                                  [&](int, int n0, int sq, int rows, float (&acc)[RT][4], int) {
                                    bias_relu<RT>(acc, bias, n0, rows);
                                    store_tile<RT>(dst, n0, sq, rows, acc);
                                    if (st_l) store_tile<RT>(st_l, n0, sq, rows, acc);
                                  });
                in = dst;
                K = H;
              }
              const float* W = weights_ready<STAGED>(ring, w_src(L));
              if (c < 3 || j + 1 < j1) fetch_weights<STAGED>(ring, w_src(0), w_n(0));
              dense_out<BF16>(W, bias0 + L * H, in, R, K);
            } else {
              __syncthreads();
              save_x();
            }
            __syncthreads();
            if (owner) {
              const float wgt = (c == 1 || c == 2) ? 2.0f : 1.0f;
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                if (use_mlp) k[s] += R[s * WTILE + tid];
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
      };

      // Reverse sweep over one substep whose stages were saved in the 4 slots
      // from `saved`: ybar, the cotangent of the substep's output, becomes
      // that of its input. From Y' = Y + (h/6)(k1 + 2 k2 + 2 k3 + k4),
      // k2 = f(Y + h/2 k1), k3 = f(Y + h/2 k2), k4 = f(Y + h k3): the k's get
      // (h/6) ybar times their weights, and walking k4 .. k1 each stage's state
      // cotangent is added to Y's and, scaled by the stage's step fraction, to
      // the k before it. With DIFF_W every layer's output cotangent is saved
      // beside the stage's activations, and the substep's weight and bias
      // cotangents follow.
      auto reverse_substep = [&](float* saved) {
        float go[NS], acc[NS], dk[NS];
        const float h6 = h / 6.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          go[s] = h6 * ybar[s];  // cotangent of the weighted sum of the k's
          acc[s] = ybar[s];      // Y' = Y + ...: Y gets ybar
          dk[s] = go[s];         // k4
        }
        if (use_mlp) fetch_weights<STAGED>(ring, w_src(L), w_n(L));
        for (int c = 3; c >= 0; --c) {
          float* st = saved + (size_t)c * slot;
          float* sg = st + (size_t)rows_a * WTILE;  // the stage's output cotangents
          if (use_mlp) {
            if (owner) {
#pragma unroll
              for (int s = 0; s < NOUT; ++s) {
                const float v = s < NS ? dk[s] : 0.f;
                R[s * WTILE + tid] = v;
                if (diff_w) sg[(L * H + s) * WTILE + tid] = v;
              }
            }
            // through the layers backwards: g is the cotangent of layer l's
            // pre-activation output, u that of its input
            const float* g = R;
            for (int l = L; l >= 0; --l) {
              const float* W = weights_ready<STAGED>(ring, w_src(l));
              // the next layer's weights, started after this product's mask
              auto fetch = [&]() {
                if (l == 0 && c == 0) return false;
                const int nl = l > 0 ? l - 1 : L;
                fetch_weights<STAGED>(ring, w_src(nl), w_n(nl));
                return STAGED;
              };
              // u: this layer's input cotangent, the previous layer's output's
              // (free: the product before last read it, behind the barrier)
              float* u = l == 0 ? dX : gbuf(l - 1);
              const float* act = l > 0 ? st + (size_t)(in_pad + (l - 1) * H) * WTILE : nullptr;
              float* gsave = l > 0 && diff_w ? sg + (size_t)(l - 1) * H * WTILE : nullptr;
              input_cot_any<BF16>(W, g, u, act, gsave, l == 0 ? in_pad : H, l == L ? NOUT : H,
                                  fetch);
              g = u;
            }
            __syncthreads();
          }
          if (owner) {
            float yb[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s) yb[s] = 0.f;
            if (use_mlp) {
              // features X = [t, y(6), GLP1, tVNS, context...]
#pragma unroll
              for (int s = 0; s < NS; ++s) yb[s] = dX[(1 + s) * WTILE + tid];
              yb[3] += dX[7 * WTILE + tid];
              if (diff_p && n_cp == 0)
                for (int r = 0; r < C; ++r) dCs[r * WTILE + tid] += dX[(NF + r) * WTILE + tid];
            }
            if (use_mech) {
              float P[NP], pb[NP], ys[NS];
#pragma unroll
              for (int p = 0; p < NP; ++p) P[p] = Ps[p * WTILE + tid];
#pragma unroll
              for (int s = 0; s < NS; ++s) ys[s] = st[(1 + s) * WTILE + tid];
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
                        dCs[r * WTILE + tid] += pb[p];
                      } else {
                        const float e = valid ? expf(ctx[r * B + b]) : 1.f;
                        dPs[p * WTILE + tid] += pb[p] * e;
                        dCs[r * WTILE + tid] += (pb[p] * pvec[p]) * e;
                      }
                    }
                }
#pragma unroll
                for (int p = 0; p < NP; ++p)
                  if (!conditioned[p]) dPs[p * WTILE + tid] += pb[p];
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

        if (use_mlp && diff_w) {
          __syncthreads();  // every stage's cotangent rows are written
          for (int l = 0; l <= L; ++l) {
            const int K = l == 0 ? in_pad : H, N = l < L ? H : NOUT;
            float* D = part + layer_offset(l, in_pad, H);
            float* Db = part + bias_off + l * H;
            const float* a_l = saved + (size_t)(l == 0 ? 0 : in_pad + (l - 1) * H) * WTILE;
            const float* g_l = saved + (size_t)(rows_a + l * H) * WTILE;
            if (K % 8 == 0 && N % 8 == 0 && (K / 8) * (N / 8) >= NTHREADS)
              substep_weight_cot<BF16, 8, 8>(D, Db, a_l, g_l, slot, K, N, ring);
            else
              substep_weight_cot<BF16, 4, 4>(D, Db, a_l, g_l, slot, K, N, ring);
          }
        }
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
        forward(0, substeps, (probe_fwd || recompute) ? nullptr : scr, recompute && !probe_fwd);
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
              for (int s = 0; s < NS; ++s) y[s] = Ys[(j * NS + s) * WTILE + tid];
            }
            forward(j, j + 1, scr, false);
          }
          reverse_substep(recompute ? scr : scr + (size_t)4 * j * slot);
        }
      }
      if (valid) {
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = ybar[s] + gbar[(iv * NS + s) * B + b];
      }
      __syncthreads();  // the next interval's owner phase rewrites X and R
    }

    if (valid) {
#pragma unroll
      for (int s = 0; s < NS; ++s) ybar0[b * NS + s] = ybar[s];
      for (int r = 0; r < C; ++r) dctx_out[b * C + r] = dCs[r * WTILE + tid];
      if (!recompute)
        for (int p = 0; p < NP; ++p) dp_out[p * B + b] = dPs[p * WTILE + tid];
    }
    if (recompute) {
      // the tile's samples: a fixed butterfly over each owner warp's lanes,
      // then the two warp sums in warp order
      if (owner) {
        for (int p = 0; p < NP; ++p) {
          float v = valid ? dPs[p * WTILE + tid] : 0.f;
#pragma unroll
          for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
          if (tid % 32 == 0) R[(tid / 32) * 32 + p] = v;
        }
      }
      __syncthreads();
      if (tid < NP) dpv_blk[tid] += R[tid] + R[32 + tid];
    }
    __syncthreads();
  }
  if (recompute && tid < 32) dpv_part[blockIdx.x * 32 + tid] = dpv_blk[tid];
}

template <bool BF16, int RT, bool STAGED>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  auto kernel = fused_rk4_bwd_vjp_kernel<BF16, RT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <bool BF16, int RT, bool STAGED>
cudaError_t launch(const Layout& lay, int grid, cudaStream_t stream, const float* traj,
                   const float* gbar, const float* ts, const float* meal, const float* tvns,
                   const float* ctx, const float* wpack, const float* pvec, const int* cidx,
                   float* ybar0, float* dp, float* dpv_part, float* dctx, float* partials,
                   float* scratch, int B, int T, int C, int in_pad, int H, int n_layers,
                   int substeps, int n_cp, int abs_mode, int n_w, int schedule, int flags,
                   int fwd_passes) {
  auto kernel = fused_rk4_bwd_vjp_kernel<BF16, RT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, lay.smem, stream>>>(
      traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0, dp, dpv_part, dctx, partials,
      scratch, B, T, C, in_pad, H, n_layers, substeps, n_cp, abs_mode, n_w, schedule, flags,
      fwd_passes, lay.cap, lay.slot);
  return cudaGetLastError();
}

// fn<BF16, RT, STAGED>(args...) for the instantiation the layout and dtype name.
#define FUSED_RK4_VJP_DISPATCH(fn, bf16, lay, ...)                                          \
  ((bf16) ? ((lay).staged ? ((lay).rt == 8 ? fn<true, 8, true>(__VA_ARGS__)                 \
                                           : fn<true, 4, true>(__VA_ARGS__))                \
                          : ((lay).rt == 8 ? fn<true, 8, false>(__VA_ARGS__)                \
                                           : fn<true, 4, false>(__VA_ARGS__)))              \
          : ((lay).staged ? ((lay).rt == 8 ? fn<false, 8, true>(__VA_ARGS__)                \
                                           : fn<false, 4, true>(__VA_ARGS__))               \
                          : ((lay).rt == 8 ? fn<false, 8, false>(__VA_ARGS__)               \
                                           : fn<false, 4, false>(__VA_ARGS__))))

bool widths_ok(int C, int in_pad, int H, int n_layers, int substeps, int schedule) {
  return C >= 0 && H >= 4 && H % 4 == 0 && H <= 2 * NTHREADS && in_pad >= 4 &&
         in_pad % 4 == 0 && n_layers >= 1 && substeps >= 1 && schedule >= 0 && schedule <= 1;
}

}  // namespace

// What a caller allocates for a launch on these shapes:
//   sizes[0]  samples per tile
//   sizes[1]  blocks to launch: those that can be resident at once, at most
//             one per tile
//   sizes[2]  floats of `scratch` per block (stage slots x floats per slot)
//   sizes[3]  floats of `partials` per block (the packed weights and biases)
//   sizes[4]  1 when the weights are staged through shared memory
//   sizes[5]  bytes of shared memory per block
// ('recompute' also takes dpv_part, (sizes[1], 32).)
extern "C" int fused_rk4_bwd_vjp_sizes(int B, int C, int in_pad, int H, int n_layers,
                                       int substeps, int schedule, int bf16, long long* sizes) {
  if (B < 1 || !widths_ok(C, in_pad, H, n_layers, substeps, schedule))
    return (int)cudaErrorInvalidValue;
  Layout lay;
  if (vjp_layout(C, in_pad, H, n_layers, substeps, schedule, &lay))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = FUSED_RK4_VJP_DISPATCH(resident_blocks, bf16, lay, lay.smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + WTILE - 1) / WTILE;
  sizes[0] = WTILE;
  sizes[1] = tiles < blocks ? tiles : blocks;
  sizes[2] = lay.scratch;
  sizes[3] = layer_offset(n_layers, in_pad, H) + H * NOUT + n_layers * H + NOUT;
  sizes[4] = lay.staged;
  sizes[5] = (long long)lay.smem;
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
  if (B < 1 || T < 1 || !widths_ok(C, in_pad, H, n_layers, substeps, schedule) ||
      in_pad < NF + (n_cp ? 0 : C) || n_cp < 0 || n_cp > NP || (n_cp && n_cp != C) ||
      (C && (!ctx || !dctx)) || (n_cp && !cidx) || grid < 1 || flags < 0 || flags > 15 ||
      fwd_passes < 0 || fwd_passes > 2 || (schedule == 0 && (!dpv || !dpv_part)) ||
      (schedule == 1 && !dp) ||
      n_w != in_pad * H + (n_layers - 1) * H * H + H * NOUT + n_layers * H + NOUT ||
      (long long)T * NS * B > 0x7fffffffLL)  // int offsets
    return (int)cudaErrorInvalidValue;
  Layout lay;
  if (vjp_layout(C, in_pad, H, n_layers, substeps, schedule, &lay))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = FUSED_RK4_VJP_DISPATCH(
      launch, bf16, lay, lay, grid, s, traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0,
      dp, dpv_part, dctx, partials, scratch, B, T, C, in_pad, H, n_layers, substeps, n_cp,
      abs_mode, n_w, schedule, flags, fwd_passes);
  if (err != cudaSuccess) return (int)err;
  sum_rows<<<(n_w + 255) / 256, 256, 0, s>>>(partials, grid, n_w, dflat);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (schedule == 0) {
    sum_rows<<<1, 32, 0, s>>>(dpv_part, grid, 32, dpv);
    err = cudaGetLastError();
  }
  return (int)err;
}
