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
// Per interval i = T-2 .. 0 a block runs three phases on its 64-sample tile:
//   1. one forward pass from traj[i] that saves every stage's MLP input X,
//      post-ReLU activations and ReLU masks;
//   2. the reverse sweep, substeps backwards and stages 4, 3, 2, 1: the MLP
//      transpose (masked by the saved bits) and the hand-derived mechanistic
//      Jacobian-transpose, saving every layer's output cotangent;
//   3. the weight and bias cotangents of the whole interval, one product per
//      layer that contracts over all 4 * substeps stages x 64 samples.
// The forward pass takes fused_rk4_fwd.cu's products (fused_rk4_wide.cuh) and
// fused_rk4_common.cuh's `mech`, so the states it rebuilds are the ones the
// forward took: pre-activations are accumulated k ascending by fmaf, then the
// bias, then the ReLU, in all three kernels.
//
// What bounds it on an H100: arithmetic. Per stage evaluation the MLP is
// done three times (recompute, weight cotangent, input cotangent): at the
// cohort shape (B = 8192, T = 61, substeps = 4, H = 128, 16 context
// features) about 2.5e12 FLOP, 38 ms at the 67 TFLOP/s f32 CUDA-core peak,
// against about 30 MB of inputs and outputs. f32 products stay on the CUDA
// cores.
//
// Design:
//   * Weight cotangents, batched per interval. Phases 1 and 2 write the
//     operands to the block's slice of global `scratch` as they write them
//     to shared memory, [row][sample] (whole 256-byte rows per half warp):
//     per stage A holds X and the L activations (in_pad + L*H rows), G each
//     layer's masked output cotangent and the residual's (L*H + 8 rows).
//     Phase 3 streams both through shared memory in chunks of columns
//     (cp.async, two buffers, the next chunk arriving while this one
//     multiplies) and computes dW_l += A_l G_l^T with an 8 x 8 register tile
//     per thread (4 x 4 for layers that would leave threads without a tile),
//     contracting over all 4 * substeps * 64 columns. Operands are read as
//     float4 along the columns, 16 loads per 256 FMA; rows are padded by four
//     floats so that the lanes' rows fall on different banks. The block's
//     slice of `partials` is read and written once per interval and layer,
//     not once per stage.
//   * Across blocks: blocks run in no order, so block g accumulates into its
//     own slice partials[g] (the packed weight layout) with plain
//     read-modify-writes; every element always belongs to the same thread.
//     `sum_rows` (fused_rk4_common.cuh) then adds the slices in block order.
//     No atomics anywhere: two launches on the same inputs give bitwise
//     equal outputs.
//   * The grid is the number of blocks that can be resident at once (one
//     per SM: 132 slices of 217 KB stay in L2), at most one per tile; block g
//     walks tiles g, g + gridDim.x, ...
//   * MLP weights come from shared memory, one layer at a time through the
//     same two buffers (fused_rk4_wide.cuh), for the forward products and,
//     from a transposed copy the caller appends to the packed weights
//     (layer l as (out, in) row-major), for the transposed ones: the input
//     cotangent u = W g is then the forward product's loop on W^T, with the
//     same conflict-free reads. Route `staged`: taken when two layers fit
//     beside the activations (H <= 128 at the usual widths). Otherwise the
//     products read both copies from global memory and phase 3 stages its
//     chunks through what shared memory is left (H up to about 380).
//   * ReLU masks are 32 bits per thread tile, written in phase 1 by the
//     thread that reads them in phase 2 (both products have the layer's
//     width, hence the same tiling), so phase 2 waits on one word, loaded
//     before the product, not on the activations.
//   * Thread tid < WTILE owns one sample: its RK4 cotangents live in
//     registers; its parameters, parameter cotangents, stage-state
//     cotangents and feature-mode context cotangents in shared memory.
//
// Small batches take the cluster route (`fused_rk4_bwd_kernel_cluster`, the
// caller chooses the route; fused_rk4_wide.cuh): one tile of min(64, B
// rounded up to 4) samples on a cluster of 8 CTAs, at H = 128 with in_pad 16
// or 32 (other widths take the wide route). Phases 1 and 2 split every product, the
// forward ones and the transposed ones, by output rows, each CTA keeping its
// slices of both weight copies resident; phase 3 gives each CTA the weight
// and bias cotangents of its own output columns over the interval's
// columns, so a cluster needs no partials inside itself and one slice per
// cluster goes to `sum_rows`, in cluster order. Bias cotangents sum the
// wide route's column groups (bias_sums) in its order, so every output
// equals the wide route's bitwise. Between phases, a cluster barrier; ReLU
// masks stay per CTA in scratch. Phases 1 and 2 take the forward's product
// variants (fused_rk4_wide.cuh, Products; the library takes the same one for
// the same widths), the transposed products of a width on the tiles of the
// forward product of that width, so that each thread reads back the masks it
// wrote. Phase 3 is about 35% of the route's time at B = 32 and 30% at B = 1
// (measured, PERF.md section 6).
//
// mlp_dtype='bf16' is the template argument BF16 (fused_rk4_common.cuh): both
// operands of every product, forward and transposed, are rounded to bf16 at
// the load (both weight copies arrive rounded); sums, bias cotangents, masks
// and every accumulator stay f32. The f32 instantiation is the code without it.
//
// Built with -fmad=false (hybrid_ode_torch/ops/fused_rk4.py): the matmul
// loops use explicit fmaf; everything else rounds after each operation, as
// the plain PyTorch version's tensor ops do, so the adjoint's recomputed
// ReLU masks match the plain version's (kernel-vs-plain stays ~1e-6).
//
// Interface: plain C functions taking device pointers and the stream, loaded
// with ctypes (hybrid_ode_torch/ops/fused_rk4.py). They return cudaError_t.

#include "fused_rk4_wide.cuh"

namespace {

using namespace fused_rk4;

constexpr int OUTER_UNROLL = 2;  // column quads per trip of outer_w's loop (1: 2% slower)

// Columns per chunk of phase 3's ring on the wide route: the most (64, 32,
// ...) whose K + N rows, padded by 4, fit a ring buffer of cap floats.
__host__ __device__ inline int chunk_cols(int K, int N, int cap) {
  int cc = WTILE;
  while (cc > 4 && (K + N) * (cc + 4) > cap) cc /= 2;
  return cc;
}

// D[k][n] += sum_col A[k][col] * G[n][col] for k < K, n < N (D with rows of
// ldd floats) and Db[n] += sum_col G[n][col], over the tw columns of each of
// n_stages stages. A and G are global, [stage][rows][tw] with rows_a /
// rows_g rows per stage, and pass through the ring in chunks of cc columns
// (the last of a stage shorter where cc does not divide tw), rows padded to
// cc + 4 floats so that consecutive rows start four banks apart. A thread owns
// rows k0 .. k0 + TK of A (the lanes that share them read one address) and
// rows tn, tn + N / TN, ... of G (consecutive lanes, consecutive rows: no bank
// conflict), i.e. a TK x TN tile of D in registers for the whole contraction,
// read as float4 along the columns. Element (k, n) and Db[n] always belong to
// the same thread, and columns are added in ascending order. Db sums a
// chunk's columns from 0 before adding them; a null Db leaves the bias
// cotangents to the caller (the cluster route: bias_sums). TW fixes the
// tile width at compile time (the wide route's WTILE, which every chunk
// divides, so every chunk is cc columns wide); 0 takes tw as given (the
// cluster route).
// BF16: both operands are read rounded for the product; Db takes G as it is.
template <bool BF16, int TK, int TN, int TW = 0>
__device__ __forceinline__ void outer_w(float* D, int ldd, float* Db, const float* A, int rows_a,
                                        const float* G, int rows_g, int n_stages, int K, int N,
                                        int tw_in, int cc, Ring& ring) {
  const int tw = TW ? TW : tw_in;
  const int tid = threadIdx.x;
  const int tiles_n = N / TN, tiles = (K / TK) * tiles_n;
  const int ld = cc + 4, ld4 = ld / 4;
  const int per_stage = (tw + cc - 1) / cc, n_chunks = n_stages * per_stage;
  auto quads = [&](int c0) {  // a chunk's width / 4
    return TW ? cc / 4 : (tw - c0 < cc ? tw - c0 : cc) / 4;
  };
  auto load = [&](int ch) {
    float* a_dst = ring.incoming();
    float* g_dst = a_dst + K * ld;
    const size_t st = ch / per_stage;
    const int c0 = (ch % per_stage) * cc, c4n = quads(c0);
    const float* a_src = A + st * rows_a * tw + c0;
    const float* g_src = G + st * rows_g * tw + c0;
    for (int i = tid; i < K * c4n; i += NTHREADS) {
      const int r = i / c4n, q = i % c4n;
      __pipeline_memcpy_async(a_dst + r * ld + 4 * q, a_src + r * tw + 4 * q, 16);
    }
    for (int i = tid; i < N * c4n; i += NTHREADS) {
      const int r = i / c4n, q = i % c4n;
      __pipeline_memcpy_async(g_dst + r * ld + 4 * q, g_src + r * tw + 4 * q, 16);
    }
    ring.commit();
  };
  for (int t0 = 0; t0 < tiles; t0 += NTHREADS) {
    const int t = t0 + tid;
    const bool active = t < tiles;
    const int k0 = active ? (t / tiles_n) * TK : 0, tn = active ? t % tiles_n : 0;
    float acc[TK][TN];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    load(0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const float* As = ring.arrive();
      const float* Gs = As + K * ld;
      if (ch + 1 < n_chunks) load(ch + 1);
      const int c0 = (ch % per_stage) * cc, c4n = quads(c0);
      if (active) {
        const float4* a4 = reinterpret_cast<const float4*>(As + k0 * ld);
        const float4* g4 = reinterpret_cast<const float4*>(Gs + tn * ld);
#pragma unroll OUTER_UNROLL
        for (int c4 = 0; c4 < c4n; ++c4) {
          float av[TK][4], gv[TN][4];
#pragma unroll
          for (int i = 0; i < TK; ++i) {
            const float4 a = a4[i * ld4 + c4];
            av[i][0] = operand<BF16>(a.x); av[i][1] = operand<BF16>(a.y);
            av[i][2] = operand<BF16>(a.z); av[i][3] = operand<BF16>(a.w);
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float4 g = g4[j * tiles_n * ld4 + c4];
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
      if (t0 == 0 && Db)
        for (int nn = tid; nn < N; nn += NTHREADS) {
          float sum = 0.f;
          for (int c = 0; c < 4 * c4n; ++c) sum += Gs[nn * ld + c];
          Db[nn] += sum;
        }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) D[(size_t)(k0 + i) * ldd + tn + j * tiles_n] += acc[i][j];
    }
  }
}

// The wide route's: all N columns of D (K, N) row-major, WTILE columns a
// stage, chunks as wide as the ring holds.
template <bool BF16, int TK, int TN>
__device__ __forceinline__ void outer_w(float* D, float* Db, const float* A, int rows_a,
                                        const float* G, int rows_g, int n_stages, int K, int N,
                                        Ring& ring) {
  const int cc = chunk_cols(K, N, ring.cap);
  outer_w<BF16, TK, TN, WTILE>(D, N, Db, A, rows_a, G, rows_g, n_stages, K, N, WTILE, cc, ring);
}

// Db[n] += the sum of G[stage][n][c] over each group of bcc columns of a
// stage (the last of a stage shorter), from 0, groups added in stage and
// column order: the bias cotangents as the wide route's outer_w sums them
// (its ring chunks are the groups; its tile's dead lanes add exact zeros). The
// groups' sums are independent chains, NTHREADS / N of them at once for each
// of N <= NTHREADS rows; `part` is NTHREADS floats of shared memory. G is
// global, [stage][rows_g][tw], written by this CTA.
__device__ __forceinline__ void bias_sums(float* Db, const float* G, int rows_g, int n_stages,
                                          int N, int tw, int bcc, float* part) {
  if (N < 1) return;
  const int tid = threadIdx.x, per_stage = (tw + bcc - 1) / bcc;
  const int groups = n_stages * per_stage, batch = NTHREADS / N;
  for (int g0 = 0; g0 < groups; g0 += batch) {
    const int g = g0 + tid / N, n = tid % N;
    if (tid < batch * N && g < groups) {
      const int st = g / per_stage, c0 = (g % per_stage) * bcc;
      const int c1 = c0 + bcc < tw ? c0 + bcc : tw;
      const float* row = G + ((size_t)st * rows_g + n) * tw;
      float sum = 0.f;
#pragma unroll 8
      for (int c = c0; c < c1; ++c) sum += __ldcg(row + c);
      part[tid] = sum;
    }
    __syncthreads();
    if (tid < N) {
      const int g1 = g0 + batch < groups ? g0 + batch : groups;
      for (int gg = g0; gg < g1; ++gg) Db[tid] += part[(gg - g0) * N + tid];
    }
    __syncthreads();
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

// After stage c's transposed MLP, for one sample (column `col`, rows of `ld`
// floats): the stage-state cotangent from the features' cotangent dX and the
// mechanistic transpose at the stage state xs (G, I, Glu, GLP1, FFA). Adds the
// parameter and feature-mode context cotangents, keeps dY in dYs and makes dk
// the next stage's field cotangent: dk3 = h/3 go + h dY4, dk2 = h/3 go +
// h/2 dY3, dk1 = h/6 go + h/2 dY2. Shared by both routes.
__device__ __forceinline__ void stage_transpose(int c, float h, const float (&go)[NS],
                                                float (&dk)[NS], const float (&xs)[5],
                                                const float* Ps, float* dPs, const float* dX,
                                                float* dCs, float* dYs, int ld, int col, int C,
                                                int n_cp) {
  float P[NP], dy[NS];
#pragma unroll
  for (int p = 0; p < NP; ++p) P[p] = Ps[p * ld + col];
  dy[0] = dX[1 * ld + col];
  dy[1] = dX[2 * ld + col];
  dy[2] = dX[3 * ld + col];
  dy[3] = dX[4 * ld + col] + dX[7 * ld + col];
  dy[4] = dX[5 * ld + col];
  dy[5] = dX[6 * ld + col];
  if (n_cp == 0)
    for (int r = 0; r < C; ++r) dCs[r * ld + col] += dX[(NF + r) * ld + col];
  mech_t(xs[0], xs[1], xs[2], xs[3], xs[4], dk, P, dy, dPs + col, ld);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    dYs[(c * NS + s) * ld + col] = dy[s];
    if (c == 3) dk[s] = (h / 3.0f) * go[s] + h * dy[s];
    else if (c == 2) dk[s] = (h / 3.0f) * go[s] + 0.5f * h * dy[s];
    else dk[s] = (h / 6.0f) * go[s] + 0.5f * h * dy[s];
  }
}

// What a launch needs besides its arguments, from the widths alone.
struct Layout {
  size_t smem;          // bytes of dynamic shared memory
  int cap;              // floats of one ring buffer
  int staged;           // weights through shared memory
  int rt;               // rows per thread tile of an H-wide product
  int mask_words;       // ReLU-mask words per stage and layer
  long long scratch;    // floats of a block's scratch slice
};

// 0 when the widths fit a block's shared memory.
int bwd_layout(int C, int in_pad, int H, int L, int substeps, Layout* lay) {
  // X [in_pad]; Ha [H]; Hb [max(H, in_pad)]; R [NOUT]; P, dP [NP]; dY [4][NS]; dctx [C]
  const size_t acts = sizeof(float) * WTILE *
      (size_t)(in_pad + H + (H > in_pad ? H : in_pad) + NOUT + 2 * NP + 4 * NS + C);
  if (acts >= (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int wcap = max_layer_floats(in_pad, H, L);
  const size_t left = (size_t)SMEM_LIMIT - acts;
  // phase 3 stages K + N rows of at least 4 columns, padded by 4
  const int chunk = 8 * ((in_pad > H ? in_pad : H) + H);
  const int want = wcap > chunk ? wcap : chunk;
  lay->staged = 2 * sizeof(float) * (size_t)want <= left;
  // unstaged: the ring only stages phase 3's chunks, in what is left
  lay->cap = lay->staged ? want : (int)(left / (2 * sizeof(float)) / 4 * 4);
  if (!lay->staged && lay->cap > 5 * chunk) lay->cap = 5 * chunk;  // 32 padded columns; the rest stays L1
  if (lay->cap < chunk) return (int)cudaErrorInvalidValue;
  lay->smem = acts + 2 * sizeof(float) * (size_t)lay->cap;
  lay->rt = (H / 8) * WSQ >= NTHREADS ? 8 : 4;
  lay->mask_words = ((H + lay->rt - 1) / lay->rt) * WSQ;
  const long long cols = 4LL * substeps * WTILE;
  lay->scratch = cols * (in_pad + L * H) + cols * (L * H + NOUT) +
                 4LL * substeps * L * lay->mask_words;
  return 0;
}

// BF16: mlp_dtype='bf16'; RT: rows per thread tile of an H-wide product;
// STAGED: MLP weights through shared memory (fused_rk4_wide.cuh).
template <bool BF16, int RT, bool STAGED>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_rk4_bwd_kernel(const float* __restrict__ traj,  // (T, 6, B)
                     const float* __restrict__ gbar,  // (T, 6, B)
                     const float* __restrict__ ts,    // (T, B)
                     const float* __restrict__ meal,  // (T, B)
                     const float* __restrict__ tvns,  // (T, B)
                     const float* __restrict__ ctx,   // (C, B) or null
                     const float* __restrict__ wpack, // weights, biases, transposed weights
                     const float* __restrict__ pvec,  // (32,) PARAM_ORDER
                     const int* __restrict__ cidx,    // (n_cp,) or null
                     float* __restrict__ ybar0,       // (B, 6)
                     float* __restrict__ dp_out,      // (17, B)
                     float* __restrict__ dctx_out,    // (B, C) or null
                     float* __restrict__ partials,    // (gridDim.x, n_w)
                     float* __restrict__ scratch,     // (gridDim.x, scratch_floats)
                     int B, int T, int C, int in_pad, int H, int n_layers,
                     int substeps, int n_cp, int abs_mode, int n_w, int cap,
                     int mask_words, long long scratch_floats) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [in_pad][WTILE] forward features
  float* Ha = X + in_pad * WTILE;              // [H][WTILE]
  float* Hb = Ha + H * WTILE;                  // [max(H, in_pad)][WTILE]
  // the features' cotangent: the last transposed product reads Ha, so Hb is free
  float* dX = Hb;                              // [in_pad][WTILE]
  float* R = Hb + (H > in_pad ? H : in_pad) * WTILE;  // [NOUT][WTILE] residual / stage cotangent
  float* Ps = R + NOUT * WTILE;                // [NP][WTILE] effective parameters
  float* dPs = Ps + NP * WTILE;                // [NP][WTILE] their cotangents
  float* dYs = dPs + NP * WTILE;               // [4][NS][WTILE] stage-state cotangents
  float* dCs = dYs + 4 * NS * WTILE;           // [C][WTILE] feature-mode context cotangent
  Ring ring;
  ring.init(dCs + C * WTILE, cap);             // [2][cap]

  const int tid = threadIdx.x;
  const bool owner = tid < WTILE;
  const int L = n_layers;
  const int rowsA = in_pad + L * H;            // rows a stage saves of its inputs
  const int rowsG = L * H + NOUT;              // ... and of its output cotangents
  const int n_stages = 4 * substeps;
  float* part = partials + (size_t)blockIdx.x * n_w;
  float* SA = scratch + (size_t)blockIdx.x * scratch_floats;  // [stage][rowsA][WTILE]
  float* SG = SA + (size_t)n_stages * rowsA * WTILE;          // [stage][rowsG][WTILE]
  unsigned* masks = reinterpret_cast<unsigned*>(SG + (size_t)n_stages * rowsG * WTILE);
  const int bias_off = layer_offset(L, in_pad, H) + H * NOUT;
  const float* bias0 = wpack + bias_off;
  const float* wt0 = wpack + n_w;  // the transposed copies, in the layers' order
  auto w_src = [&](int l) { return wpack + layer_offset(l, in_pad, H); };
  auto wt_src = [&](int l) { return wt0 + layer_offset(l, in_pad, H); };
  auto w_n = [&](int l) { return layer_floats(l, in_pad, H, L); };
  const float inv_s = 1.0f / (float)substeps;

  for (int i = tid; i < n_w; i += NTHREADS) part[i] = 0.f;

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

      // ---- phase 1: forward pass over the interval, saving every stage ----
      fetch_weights<STAGED>(ring, w_src(0), w_n(0));
      for (int j = 0; j < substeps; ++j) {
        const float jf = (float)j;
        const float t = ts_l + jf * h;
        float k[NS], ksum[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) k[s] = ksum[s] = 0.f;
        for (int c = 0; c < 4; ++c) {
          const int stage = 4 * j + c;
          float* at = SA + (size_t)stage * rowsA * WTILE;  // this stage's rows
          if (owner) {
            float P[NP];
#pragma unroll
            for (int p = 0; p < NP; ++p) P[p] = Ps[p * WTILE + tid];
            stage_features(c, jf, t, h, inv_s, y, k, m_l, m_r, v_l, v_r, P, X, WTILE, tid);
          }
          const float* in = X;
          int K = in_pad;
          for (int l = 0; l < L; ++l) {
            const float* W = weights_ready<STAGED>(ring, w_src(l));
            fetch_weights<STAGED>(ring, w_src(l + 1), w_n(l + 1));
            if (l == 0 && !CUT_SAVES)  // X is complete behind the barrier: save it
              for (int e = tid; e < in_pad * WSQ; e += NTHREADS)
                reinterpret_cast<float4*>(at)[e] = reinterpret_cast<const float4*>(X)[e];
            float* dst = (l & 1) ? Hb : Ha;
            const float* bias = bias0 + l * H;
            float* at_l = at + (in_pad + l * H) * WTILE;
            unsigned* mk = masks + (size_t)(stage * L + l) * mask_words;
            dense_w<BF16, RT>(W, in, K, H, NoTag(),
                              [&](int tt, int n0, int sq, int rows, float (&acc)[RT][4], int) {
                                mk[tt] = bias_relu<RT>(acc, bias, n0, rows);
                                store_tile<RT>(dst, n0, sq, rows, acc);
                                if (!CUT_SAVES) store_tile<RT>(at_l, n0, sq, rows, acc);
                              });
            in = dst;
            K = H;
          }
          const float* W = weights_ready<STAGED>(ring, w_src(L));
          // next: the next stage's first layer, or the reverse sweep's first product
          if (stage + 1 < 4 * substeps) fetch_weights<STAGED>(ring, w_src(0), w_n(0));
          else fetch_weights<STAGED>(ring, wt_src(L), w_n(L));
          dense_out<BF16>(W, bias0 + L * H, in, R, K);
          __syncthreads();
          if (owner) stage_sum(c, R, WTILE, tid, k, ksum);
        }
        if (owner) {
          const float h6 = h / 6.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) y[s] = y[s] + h6 * ksum[s];
        }
      }

      // ---- phase 2: reverse sweep, substeps backwards, stages 4, 3, 2, 1 ----
      for (int j = CUT_SWEEP ? -1 : substeps - 1; j >= 0; --j) {
        float go[NS], dk[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          go[s] = ybar[s];
          dk[s] = (h / 6.0f) * go[s];
        }
        for (int c = 3; c >= 0; --c) {
          const int stage = 4 * j + c;
          const float* at = SA + (size_t)stage * rowsA * WTILE;
          float* gt = SG + (size_t)stage * rowsG * WTILE;
          float xs[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // the stage state G, I, Glu, GLP1, FFA
          if (owner) {
            xs[0] = at[1 * WTILE + tid]; xs[1] = at[2 * WTILE + tid];
            xs[2] = at[3 * WTILE + tid]; xs[3] = at[4 * WTILE + tid];
            xs[4] = at[6 * WTILE + tid];
            float* gr = gt + L * H * WTILE;
#pragma unroll
            for (int s = 0; s < NOUT; ++s) {
              const float v = s < NS ? dk[s] : 0.f;
              R[s * WTILE + tid] = v;
              if (!CUT_SAVES) gr[s * WTILE + tid] = v;
            }
          }
          // MLP transpose: product p takes the cotangent g of layer p's output
          // to the cotangent of its input, u = W_p g, from the transposed copy;
          // masked by layer p - 1's ReLU it is the next g
          const float* g = R;
          for (int p = L; p >= 0; --p) {
            const float* W = weights_ready<STAGED>(ring, wt_src(p));
            if (p > 0) fetch_weights<STAGED>(ring, wt_src(p - 1), w_n(p - 1));
            else if (stage > 0) fetch_weights<STAGED>(ring, wt_src(L), w_n(L));
            const int Kc = p == L ? NOUT : H;  // contraction: layer p's outputs
            if (p > 0) {
              float* gz = ((p - 1) & 1) ? Hb : Ha;
              float* gt_l = gt + (p - 1) * H * WTILE;
              const unsigned* mk = masks + (size_t)(stage * L + p - 1) * mask_words;
              dense_w<BF16, RT>(W, g, Kc, H, [&](int tt) { return mk[tt]; },
                                [&](int, int n0, int sq, int rows, float (&acc)[RT][4],
                                    unsigned bits) {
#pragma unroll
                                  for (int i = 0; i < RT; ++i)
#pragma unroll
                                    for (int jj = 0; jj < 4; ++jj)
                                      acc[i][jj] *= (bits >> (4 * i + jj)) & 1u ? 1.f : 0.f;
                                  store_tile<RT>(gz, n0, sq, rows, acc);
                                  if (!CUT_SAVES) store_tile<RT>(gt_l, n0, sq, rows, acc);
                                });
              g = gz;
            } else {
              dense_w<BF16, 4>(W, g, Kc, in_pad, NoTag(),
                               [&](int, int n0, int sq, int rows, float (&acc)[4][4], int) {
                                 store_tile<4>(dX, n0, sq, rows, acc);
                               });
            }
          }
          __syncthreads();
          if (owner)
            stage_transpose(c, h, go, dk, xs, Ps, dPs, dX, dCs, dYs, WTILE, tid, C, n_cp);
        }
        if (owner) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            ybar[s] = go[s] + dYs[(0 * NS + s) * WTILE + tid] + dYs[(1 * NS + s) * WTILE + tid] +
                      dYs[(2 * NS + s) * WTILE + tid] + dYs[(3 * NS + s) * WTILE + tid];
        }
      }
      if (valid) {
#pragma unroll
        for (int s = 0; s < NS; ++s) ybar[s] = ybar[s] + gbar[(iv * NS + s) * B + b];
      }

      // ---- phase 3: the interval's weight and bias cotangents ----
      __syncthreads();  // every stage's rows are written
      for (int l = CUT_OUTER ? L + 1 : 0; l <= L; ++l) {
        const int K = l == 0 ? in_pad : H, N = l < L ? H : NOUT;
        float* D = part + layer_offset(l, in_pad, H);
        float* Db = part + bias_off + l * H;
        const float* a_l = SA + (l == 0 ? 0 : in_pad + (l - 1) * H) * WTILE;
        const float* g_l = SG + l * H * WTILE;
        if (K % 8 == 0 && N % 8 == 0 && (K / 8) * (N / 8) >= NTHREADS)
          outer_w<BF16, 8, 8>(D, Db, a_l, rowsA, g_l, rowsG, n_stages, K, N, ring);
        else
          outer_w<BF16, 4, 4>(D, Db, a_l, rowsA, g_l, rowsG, n_stages, K, N, ring);
      }
    }

    if (valid) {
#pragma unroll
      for (int s = 0; s < NS; ++s) ybar0[b * NS + s] = ybar[s];
      // params mode: closed-form fold of the effective-parameter cotangents
      for (int r = 0; r < n_cp; ++r) {
        const int p = cidx[r];
        const float d = dPs[p * WTILE + tid];
        if (abs_mode) {
          dctx_out[b * C + r] = d;
          dPs[p * WTILE + tid] = 0.f;
        } else {
          dctx_out[b * C + r] = d * Ps[p * WTILE + tid];
          dPs[p * WTILE + tid] = d * expf(ctx[r * B + b]);
        }
      }
      if (n_cp == 0)
        for (int r = 0; r < C; ++r) dctx_out[b * C + r] = dCs[r * WTILE + tid];
      for (int p = 0; p < NP; ++p) dp_out[p * B + b] = dPs[p * WTILE + tid];
    }
    __syncthreads();
  }
  if (CUT_SWEEP) __pipeline_wait_prior(0);  // phase 1 fetched a layer for the sweep left out
}

template <bool BF16, int RT, bool STAGED>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  auto kernel = fused_rk4_bwd_kernel<BF16, RT, STAGED>;
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
                   float* ybar0, float* dp, float* dctx, float* partials, float* scratch, int B,
                   int T, int C, int in_pad, int H, int n_layers, int substeps, int n_cp,
                   int abs_mode, int n_w) {
  auto kernel = fused_rk4_bwd_kernel<BF16, RT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, lay.smem, stream>>>(
      traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0, dp, dctx, partials, scratch,
      B, T, C, in_pad, H, n_layers, substeps, n_cp, abs_mode, n_w, lay.cap, lay.mask_words,
      lay.scratch);
  return cudaGetLastError();
}

// fn<BF16, RT, STAGED>(args...) for the instantiation the layout and dtype name.
#define FUSED_RK4_BWD_DISPATCH(fn, bf16, lay, ...)                                          \
  ((bf16) ? ((lay).staged ? ((lay).rt == 8 ? fn<true, 8, true>(__VA_ARGS__)                 \
                                           : fn<true, 4, true>(__VA_ARGS__))                \
                          : ((lay).rt == 8 ? fn<true, 8, false>(__VA_ARGS__)                \
                                           : fn<true, 4, false>(__VA_ARGS__)))              \
          : ((lay).staged ? ((lay).rt == 8 ? fn<false, 8, true>(__VA_ARGS__)                \
                                           : fn<false, 4, true>(__VA_ARGS__))               \
                          : ((lay).rt == 8 ? fn<false, 8, false>(__VA_ARGS__)               \
                                           : fn<false, 4, false>(__VA_ARGS__))))

// ---- The cluster route (fused_rk4_wide.cuh): one tile of tw samples on a
// cluster of CLUSTER CTAs. CTA r owns rows [split_lo(N, r), split_lo(N, r + 1))
// of every product: of each hidden layer in phase 1, of each layer's input
// cotangent in phase 2 (H rows, or in_pad for the last transposed product),
// and the columns N of each layer's weight cotangents in phase 3.

constexpr int CLUSTER_CHUNK = 32;  // columns per chunk of phase 3's ring on the cluster route

// What a cluster-route launch needs besides its arguments.
struct ClusterLayout {
  size_t smem;          // bytes of dynamic shared memory per CTA
  int cap;              // floats of one ring buffer (phase 3's chunks)
  int wide_cap;         // the wide route's ring buffer, whose chunks order the bias sums; 0: none
  int mask_words;       // ReLU-mask words per stage and layer of a CTA
  long long scratch;    // floats of a cluster's scratch slice
};

// 0 when a CTA's shared memory holds these widths at tile width tw. A CTA
// keeps, whole launch, its slices of the forward weights ((in_pad + (L-1) H) x
// ceil(H / CLUSTER)), the last layer whole (H x 8, every CTA computes the
// 8-row residual), its biases and its slices of the transposed copy ((8 +
// (L-1) H) x ceil(H / CLUSTER) + H x ceil(in_pad / CLUSTER)), each row padded
// by 4 floats (slice_floats); then, tw floats a row, X, Ha, Hb, dX, the
// residual, P, dP, the stage-state and context cotangents; NTHREADS floats of
// bias group sums; phase 3's ring of two buffers, (max(in_pad, H) + ceil(H /
// CLUSTER)) rows of 36 floats each; the exchange's mbarriers. At H = 128,
// in_pad = 32, C = 16, L = 4: 59 KB of weights, 201 KB in all at tw = 64, 151
// KB at tw = 32. Scratch per cluster: the wide route's operand rows at tw
// columns (each row written by the CTA that owns it) and every CTA's ReLU
// masks, one word per 1 x 4 samples of its rows.
int bwd_cluster_layout(int C, int in_pad, int H, int L, int substeps, int tw, ClusterLayout* lay) {
  const int nh = split_max(H), nr = split_max(NOUT);
  const size_t wts = (size_t)slice_floats(in_pad, H) + (size_t)(L - 1) * slice_floats(H, H) +
                     (size_t)slice_ld(H) * NOUT + cluster_bias_floats(H, L) +
                     (size_t)slice_floats(NOUT, H) + (size_t)(L - 1) * slice_floats(H, H) +
                     (size_t)slice_floats(H, in_pad);
  const size_t acts = (size_t)tw * (2 * in_pad + 2 * H + NOUT + 2 * NP + 4 * NS + C);
  lay->cap = ((in_pad > H ? in_pad : H) + (nh > nr ? nh : nr)) * (CLUSTER_CHUNK + 4);
  lay->smem = sizeof(float) * (wts + acts + NTHREADS + 2 * (size_t)lay->cap + 2 * Exchange::NBAR);
  Layout wide;
  lay->wide_cap = bwd_layout(C, in_pad, H, L, substeps, &wide) ? 0 : wide.cap;
  lay->mask_words = nh * (tw / 4);
  const long long stages = 4LL * substeps;
  lay->scratch = stages * tw * ((in_pad + L * H) + (L * H + NOUT)) +
                 CLUSTER * stages * L * lay->mask_words;
  return lay->smem <= (size_t)SMEM_LIMIT ? 0 : (int)cudaErrorInvalidValue;
}

// The wide kernel's function on the cluster's partition. Every CTA holds the
// tile's per-sample state (thread tid < tw owns sample tile * tw + tid) and
// computes it alike; CTA 0 writes the per-sample outputs. V: the product
// variant (fused_rk4_wide.cuh, Products), built for H = TILED_H, which the
// library alone launches; H stays an argument, as in the forward's kernel.
// Phase 2's transposed products of layer p's width take the tiles of phase
// 1's product of it, so a thread reads back the ReLU masks it wrote.
template <bool BF16, int V>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NTHREADS, 1)
fused_rk4_bwd_kernel_cluster(const float* __restrict__ traj,  // (T, 6, B)
                             const float* __restrict__ gbar,  // (T, 6, B)
                             const float* __restrict__ ts,    // (T, B)
                             const float* __restrict__ meal,  // (T, B)
                             const float* __restrict__ tvns,  // (T, B)
                             const float* __restrict__ ctx,   // (C, B) or null
                             const float* __restrict__ wpack, // weights, biases, transposed weights
                             const float* __restrict__ pvec,  // (32,) PARAM_ORDER
                             const int* __restrict__ cidx,    // (n_cp,) or null
                             float* __restrict__ ybar0,       // (B, 6)
                             float* __restrict__ dp_out,      // (17, B)
                             float* __restrict__ dctx_out,    // (B, C) or null
                             float* __restrict__ partials,    // (clusters, n_w)
                             float* __restrict__ scratch,     // (clusters, scratch_floats)
                             int B, int T, int C, int in_pad, int H, int n_layers,
                             int substeps, int n_cp, int abs_mode, int n_w, int tw, int cap,
                             int wide_cap, int mask_words, long long scratch_floats) {
  extern __shared__ float4 smem4[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank(), tile = (int)(blockIdx.x / CLUSTER);
  const int L = n_layers, nh = split_max(H), sqn = tw / 4;
  const int lo = split_lo(H, rank), nl = split_lo(H, rank + 1) - lo;               // of H rows
  const int lo0 = split_lo(in_pad, rank), nl0 = split_lo(in_pad, rank + 1) - lo0;  // of in_pad
  const int loR = split_lo(NOUT, rank), hiR = split_lo(NOUT, rank + 1);           // of NOUT
  using TT = TileOf<V, TILED_NL>;  // tiles of the hidden products
  using TL = TileOf<V, NOUT>;      // of the last layer
  using T0 = TileOf<V, 1>;         // of the product into dX
  // slices [rows][slice_ld(K)]
  float* Wf = reinterpret_cast<float*>(smem4);     // forward slices, a layer each
  float* WL = Wf + slice_floats(in_pad, H) + (L - 1) * slice_floats(H, H);  // the last layer, whole
  float* Bs = WL + slice_ld(H) * NOUT;             // biases: [L][nh] this CTA's rows, the last 8
  float* Wt = Bs + cluster_bias_floats(H, L);      // transposed slices, products L .. 1 then 0
  float* X = Wt + slice_floats(NOUT, H) + (L - 1) * slice_floats(H, H) +
             slice_floats(H, in_pad);              // [in_pad][tw]
  float* Ha = X + in_pad * tw;                     // [H / 4][tw][4]
  float* Hb = Ha + H * tw;                         // the same
  float* dX = Hb + H * tw;                         // [in_pad][tw] the features' cotangent
  float* R = dX + in_pad * tw;                     // [NOUT][tw] residual / stage cotangent
  float* Ps = R + NOUT * tw;                       // [NP][tw] effective parameters
  float* dPs = Ps + NP * tw;                       // [NP][tw] their cotangents
  float* dYs = dPs + NP * tw;                      // [4][NS][tw] stage-state cotangents
  float* dCs = dYs + 4 * NS * tw;                  // [C][tw] feature-mode context cotangent
  float* gsum = dCs + C * tw;                      // [NTHREADS] phase 3's bias group sums
  Ring ring;
  ring.init(gsum + NTHREADS, cap);                 // [2][cap], phase 3 only
  Exchange ex;                                     // mbarriers of Ha, Hb and dX
  ex.init(reinterpret_cast<unsigned long long*>(gsum + NTHREADS + 2 * cap));
  auto wf = [&](int l) {
    return Wf + (l == 0 ? 0 : slice_floats(in_pad, H) + (l - 1) * slice_floats(H, H));
  };
  // product p's slice: p = L contracts NOUT, p = L-1 .. 1 H, p = 0 H (to its nl0 rows)
  auto wt = [&](int p) {
    return Wt + (p == L ? 0 : slice_floats(NOUT, H) + (L - 1 - p) * slice_floats(H, H));
  };

  const int tid = threadIdx.x;
  const bool owner = tid < tw;
  const int b = tile * tw + tid;
  const bool valid = owner && b < B;
  const int rowsA = in_pad + L * H, rowsG = L * H + NOUT;
  const int n_stages = 4 * substeps;
  float* part = partials + (size_t)tile * n_w;
  float* SA = scratch + (size_t)tile * scratch_floats;                     // [stage][rowsA][tw]
  float* SG = SA + (size_t)n_stages * rowsA * tw;                          // [stage][rowsG][tw]
  unsigned* masks = reinterpret_cast<unsigned*>(SG + (size_t)n_stages * rowsG * tw) +
                    (size_t)rank * n_stages * L * mask_words;
  const int bias_off = layer_offset(L, in_pad, H) + H * NOUT;
  const float* bias0 = wpack + bias_off;
  const float* wt0 = wpack + n_w;
  const float inv_s = 1.0f / (float)substeps;

  // this CTA's columns of the weight and bias cotangents; its weight slices
  for (int l = 0; l <= L; ++l) {
    const int K = l == 0 ? in_pad : H, N = l < L ? H : NOUT;
    const int n_lo = split_lo(N, rank), nn = split_lo(N, rank + 1) - n_lo;
    float* D = part + layer_offset(l, in_pad, H);
    for (int i = tid; i < K * nn; i += NTHREADS) D[(i / nn) * N + n_lo + i % nn] = 0.f;
    for (int i = tid; i < nn; i += NTHREADS) part[bias_off + l * H + n_lo + i] = 0.f;
  }
  for (int l = 0; l < L; ++l)
    load_rows(wf(l), wpack + layer_offset(l, in_pad, H), H, l == 0 ? in_pad : H, lo, nl);
  load_rows(WL, wpack + layer_offset(L, in_pad, H), NOUT, H, 0, NOUT);
  load_biases(Bs, bias0, H, L, lo, nl);
  for (int p = L; p >= 1; --p)
    load_rows(wt(p), wt0 + layer_offset(p, in_pad, H), H, p == L ? NOUT : H, lo, nl);
  load_rows(wt(0), wt0, in_pad, H, lo0, nl0);
  for (int i = tid; i < in_pad * tw; i += NTHREADS) X[i] = 0.f;
  for (int i = tid; i < C * tw; i += NTHREADS) dCs[i] = 0.f;
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
        for (int r = 0; r < C; ++r) X[(NF + r) * tw + tid] = ctx[r * B + b];
#pragma unroll
      for (int s = 0; s < NS; ++s) ybar[s] = gbar[((T - 1) * NS + s) * B + b];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      Ps[p * tw + tid] = P[p];
      dPs[p * tw + tid] = 0.f;
    }
  }
  cluster.sync();  // every CTA's shared memory is live before the first exchange
  Probes pr;
  pr.start();

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

    // ---- phase 1: forward pass over the interval, saving every stage ----
    for (int j = 0; j < substeps; ++j) {
      const float jf = (float)j;
      const float t = ts_l + jf * h;
      float k[NS], ksum[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) k[s] = ksum[s] = 0.f;
      for (int c = 0; c < 4; ++c) {
        const int stage = 4 * j + c;
        float* at = SA + (size_t)stage * rowsA * tw;
        pr.lap(PP_STAGE, false);
        if (owner) {
          float P[NP];
#pragma unroll
          for (int p = 0; p < NP; ++p) P[p] = Ps[p * tw + tid];
          stage_features(c, jf, t, h, inv_s, y, k, m_l, m_r, v_l, v_r, P, X, tw, tid);
        }
        __syncthreads();
        pr.lap(PP_DRIFT, false);
        for (int e = tid; e < nl0 * sqn; e += NTHREADS)  // this CTA's rows of X
          reinterpret_cast<float4*>(at)[lo0 * sqn + e] =
              reinterpret_cast<const float4*>(X)[lo0 * sqn + e];
        const float* in = X;
        for (int l = 0; l < L; ++l) {
          float* dst = (l & 1) ? Hb : Ha;
          const float* bias = Bs + l * nh;
          float* at_l = at + (in_pad + l * H) * tw;
          unsigned* mk = masks + (size_t)(stage * L + l) * mask_words;
          auto epi = [&](int tt, int n0, int s0, float (&acc)[TT::RT][TT::CT], int) {
            TT::put_mask(mk, tt, cl_bias_relu(acc, bias, n0));
            cl_store_ilv(dst, tw, lo + n0, s0, acc);
            cl_store(at_l, tw, lo + n0, s0, acc);
          };
          if (l)
            cl_dense<BF16, TILED_H, TILED_NL, TT, true>(wf(l), in, unhoisted(tw), NoTag(), epi);
          else if (in_pad == 32)
            cl_dense<BF16, 32, TILED_NL, TT, false>(wf(0), X, unhoisted(tw), NoTag(), epi);
          else
            cl_dense<BF16, 16, TILED_NL, TT, false>(wf(0), X, unhoisted(tw), NoTag(), epi);
          pr.lap(l ? PP_HIDDEN : PP_LAYER0);
          ex.publish(dst + lo * tw, l & 1, 4 * nl * tw);
          ex.wait(l & 1, 4 * (H - nl) * tw);  // the layer's rows are in every CTA; `in` is free
          pr.lap(PP_EXCHANGE, false);
          in = dst;
        }
        cl_dense<BF16, TILED_H, NOUT, TL, true>(
            WL, in, unhoisted(tw), NoTag(),
            [&](int, int n0, int s0, float (&acc)[TL::RT][TL::CT], int) {
#pragma unroll
              for (int i = 0; i < TL::RT; ++i)
#pragma unroll
                for (int j = 0; j < TL::CT; ++j) acc[i][j] = acc[i][j] + Bs[L * nh + n0 + i];
              cl_store(R, tw, n0, s0, acc);
            });
        pr.lap(PP_LAST);
        // with L odd the last layer read Ha, which the next stage's first product fills
        if (L & 1) cluster_barrier();
        else __syncthreads();
        if (owner) stage_sum(c, R, tw, tid, k, ksum);
      }
      if (owner) {
        const float h6 = h / 6.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) y[s] = y[s] + h6 * ksum[s];
      }
    }
    cluster_barrier();  // the last layer read the buffer the sweep's first product fills
    pr.lap(PP_STAGE, false);

    // ---- phase 2: reverse sweep, substeps backwards, stages 4, 3, 2, 1 ----
    for (int j = substeps - 1; j >= 0; --j) {
      float go[NS], dk[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        go[s] = ybar[s];
        dk[s] = (h / 6.0f) * go[s];
      }
      for (int c = 3; c >= 0; --c) {
        const int stage = 4 * j + c;
        const float* at = SA + (size_t)stage * rowsA * tw;
        float* gt = SG + (size_t)stage * rowsG * tw;
        float xs[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // the stage state G, I, Glu, GLP1, FFA
        if (owner) {
          // rows other CTAs saved: read past L1, which may hold an older interval's
          xs[0] = __ldcg(at + 1 * tw + tid); xs[1] = __ldcg(at + 2 * tw + tid);
          xs[2] = __ldcg(at + 3 * tw + tid); xs[3] = __ldcg(at + 4 * tw + tid);
          xs[4] = __ldcg(at + 6 * tw + tid);
          float* gr = gt + L * H * tw;
#pragma unroll
          for (int s = 0; s < NOUT; ++s) {
            const float v = s < NS ? dk[s] : 0.f;
            R[s * tw + tid] = v;
            if (s >= loR && s < hiR) gr[s * tw + tid] = v;
          }
        }
        __syncthreads();
        pr.lap(PP_T_STAGE, false);
        // product p takes the cotangent g of layer p's output to this CTA's rows
        // of its input's, u = W_p g; masked by layer p - 1's ReLU it is the next g
        const float* g = R;
        for (int p = L; p >= 0; --p) {
          if (p > 0) {
            float* gz = ((p - 1) & 1) ? Hb : Ha;
            float* gt_l = gt + (p - 1) * H * tw;
            const unsigned* mk = masks + (size_t)(stage * L + p - 1) * mask_words;
            auto pre = [&](int tt) { return TT::mask(mk, tt); };
            auto epi = [&](int, int n0, int s0, float (&acc)[TT::RT][TT::CT], unsigned bits) {
#pragma unroll
              for (int i = 0; i < TT::RT; ++i)
#pragma unroll
                for (int j = 0; j < TT::CT; ++j)
                  acc[i][j] *= (bits >> (TT::CT * i + j)) & 1u ? 1.f : 0.f;
              cl_store_ilv(gz, tw, lo + n0, s0, acc);
              cl_store(gt_l, tw, lo + n0, s0, acc);
            };
            if (p == L)
              cl_dense<BF16, NOUT, TILED_NL, TT, false>(wt(p), g, unhoisted(tw), pre, epi);
            else
              cl_dense<BF16, TILED_H, TILED_NL, TT, true>(wt(p), g, unhoisted(tw), pre, epi);
            pr.lap(p == L ? PP_T_FIRST : PP_T_HIDDEN);
            ex.publish(gz + lo * tw, (p - 1) & 1, 4 * nl * tw);
            ex.wait((p - 1) & 1, 4 * (H - nl) * tw);
            pr.lap(PP_T_EXCHANGE, false);
            g = gz;
          } else {
            auto epi = [&](int, int n0, int s0, float (&acc)[T0::RT][T0::CT], int) {
              cl_store(dX, tw, lo0 + n0, s0, acc);
            };
            if (in_pad == 32)
              cl_dense<BF16, TILED_H, 32 / CLUSTER, T0, true>(wt(0), g, unhoisted(tw), NoTag(),
                                                               epi);
            else
              cl_dense<BF16, TILED_H, 16 / CLUSTER, T0, true>(wt(0), g, unhoisted(tw), NoTag(),
                                                               epi);
            pr.lap(PP_T_INPUT);
            ex.publish(dX + lo0 * tw, 2, 4 * nl0 * tw);
            ex.wait(2, 4 * (in_pad - nl0) * tw);
            pr.lap(PP_T_EXCHANGE, false);
          }
        }
        if (owner)
          stage_transpose(c, h, go, dk, xs, Ps, dPs, dX, dCs, dYs, tw, tid, C, n_cp);
      }
      if (owner) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          ybar[s] = go[s] + dYs[(0 * NS + s) * tw + tid] + dYs[(1 * NS + s) * tw + tid] +
                    dYs[(2 * NS + s) * tw + tid] + dYs[(3 * NS + s) * tw + tid];
      }
    }
    if (valid) {
#pragma unroll
      for (int s = 0; s < NS; ++s) ybar[s] = ybar[s] + gbar[(iv * NS + s) * B + b];
    }

    // ---- phase 3: this CTA's columns of the interval's weight and bias cotangents ----
    pr.lap(PP_T_STAGE);
    cluster_barrier();  // every CTA's saved rows are visible
    for (int l = 0; l <= L; ++l) {
      const int K = l == 0 ? in_pad : H, N = l < L ? H : NOUT;
      const int n_lo = split_lo(N, rank), nn = split_lo(N, rank + 1) - n_lo;
      float* D = part + layer_offset(l, in_pad, H) + n_lo;
      float* Db = part + bias_off + l * H + n_lo;
      const float* a_l = SA + (l == 0 ? 0 : in_pad + (l - 1) * H) * tw;
      const float* g_l = SG + (l * H + n_lo) * tw;
      // the bias sums' column groups are the wide route's ring chunks
      bias_sums(Db, g_l, rowsG, n_stages, nn, tw,
                wide_cap ? chunk_cols(K, N, wide_cap) : CLUSTER_CHUNK, gsum);
      auto outer = [&](auto tk, auto tn) {
        outer_w<BF16, decltype(tk)::value, decltype(tn)::value>(
            D, N, nullptr, a_l, rowsA, g_l, rowsG, n_stages, K, nn, tw, CLUSTER_CHUNK, ring);
      };
      // tiles of 2 x 4 (2 x 1) give a 16-column slice 256 threads; one pass over the chunks
      if (nn % 4 == 0 && (K / 2) * (nn / 4) <= NTHREADS) outer(Int<2>(), Int<4>());
      else if (nn % 4 == 0) outer(Int<4>(), Int<4>());
      else if ((K / 2) * nn <= NTHREADS) outer(Int<2>(), Int<1>());
      else outer(Int<4>(), Int<1>());
    }
    cluster_barrier();  // nobody reads this interval's scratch rows while the next writes them
    pr.lap(PP_OUTER, false);
  }
  pr.finish();
  ex.drain();
  cluster.sync();  // no CTA leaves while a peer may still write into it

  if (valid && rank == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) ybar0[b * NS + s] = ybar[s];
    // params mode: closed-form fold of the effective-parameter cotangents
    for (int r = 0; r < n_cp; ++r) {
      const int p = cidx[r];
      const float d = dPs[p * tw + tid];
      if (abs_mode) {
        dctx_out[b * C + r] = d;
        dPs[p * tw + tid] = 0.f;
      } else {
        dctx_out[b * C + r] = d * Ps[p * tw + tid];
        dPs[p * tw + tid] = d * expf(ctx[r * B + b]);
      }
    }
    if (n_cp == 0)
      for (int r = 0; r < C; ++r) dctx_out[b * C + r] = dCs[r * tw + tid];
    for (int p = 0; p < NP; ++p) dp_out[p * B + b] = dPs[p * tw + tid];
  }
}

template <bool BF16, int V>
cudaError_t launch_cluster(const ClusterLayout& lay, int clusters, cudaStream_t stream,
                           const float* traj, const float* gbar, const float* ts,
                           const float* meal, const float* tvns, const float* ctx,
                           const float* wpack, const float* pvec, const int* cidx, float* ybar0,
                           float* dp, float* dctx, float* partials, float* scratch, int B, int T,
                           int C, int in_pad, int H, int n_layers, int substeps, int n_cp,
                           int abs_mode, int n_w, int tw) {
  auto kernel = fused_rk4_bwd_kernel_cluster<BF16, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (err != cudaSuccess) return err;
  kernel<<<clusters * CLUSTER, NTHREADS, lay.smem, stream>>>(
      traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0, dp, dctx, partials, scratch, B, T,
      C, in_pad, H, n_layers, substeps, n_cp, abs_mode, n_w, tw, lay.cap, lay.wide_cap,
      lay.mask_words, lay.scratch);
  return cudaGetLastError();
}

}  // namespace

// What a caller allocates for a launch on these shapes, on the wide route
// (tw = 0) or on the cluster route with tiles of tw samples:
//   sizes[0]  samples per tile
//   sizes[1]  slices of `scratch` and `partials`: on the wide route the blocks
//             to launch, those that can be resident at once, at most one per
//             tile; on the cluster route one per tile (cluster)
//   sizes[2]  floats of `scratch` per slice
//   sizes[3]  floats of `partials` per slice (the packed weights and biases)
//   sizes[4]  1 when the weights are staged through, or kept in, shared memory
//   sizes[5]  CTAs per slice: 1, or CLUSTER on the cluster route
//   sizes[6]  1 when a block's shared memory holds these widths; on the
//             cluster route, when a product variant runs them at tw and a
//             CTA's shared memory holds them (else they take the wide route)
//   sizes[7]  on the cluster route, the clusters the card runs at once
//   sizes[8]  on the cluster route, the variant it launches (Products;
//             PRODUCTS_NONE where none runs these widths)
extern "C" int fused_rk4_bwd_grid(int B, int C, int in_pad, int H, int n_layers, int substeps,
                                  int bf16, int tw, long long* sizes) {
  if (B < 1 || C < 0 || H < 4 || H % 4 != 0 || in_pad < 4 || in_pad % 4 != 0 || n_layers < 1 ||
      substeps < 1 || tw < 0 || tw > WTILE || tw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  sizes[3] = layer_offset(n_layers, in_pad, H) + H * NOUT + n_layers * H + NOUT;
  if (tw) {
    ClusterLayout cl;
    const int products = cluster_products(in_pad, H, tw);
    sizes[6] = products != PRODUCTS_NONE &&
               bwd_cluster_layout(C, in_pad, H, n_layers, substeps, tw, &cl) == 0;
    sizes[0] = tw;
    sizes[1] = (B + tw - 1) / tw;
    sizes[2] = sizes[6] ? cl.scratch : 0;
    sizes[4] = 1;
    sizes[5] = CLUSTER;
    sizes[7] = 0;
    sizes[8] = products;
    if (!sizes[6]) return 0;
    int clusters = 0;
    const size_t smem = cl.smem;
    const cudaError_t err =
        products == PRODUCTS_NARROW
            ? max_clusters(fused_rk4_bwd_kernel_cluster<false, PRODUCTS_NARROW>, smem, &clusters)
            : max_clusters(fused_rk4_bwd_kernel_cluster<false, PRODUCTS_WIDE>, smem, &clusters);
    sizes[7] = clusters;
    return (int)err;
  }
  Layout lay;
  if (bwd_layout(C, in_pad, H, n_layers, substeps, &lay)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = FUSED_RK4_BWD_DISPATCH(resident_blocks, bf16, lay, lay.smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + WTILE - 1) / WTILE;
  sizes[0] = WTILE;
  sizes[1] = tiles < blocks ? tiles : blocks;
  sizes[2] = lay.scratch;
  sizes[4] = lay.staged;
  sizes[5] = 1;
  sizes[6] = 1;
  sizes[7] = 0;
  sizes[8] = 0;
  return 0;
}

// wpack: the packed weights and biases (n_w floats), then every layer's
// weights once more transposed, (out, in) row-major, in the layers' order.
// tw: 0 for the wide route, else the cluster route with tiles of tw samples,
// where fused_rk4_bwd_grid says it fits; grid: the slices fused_rk4_bwd_grid
// reported for it. The caller chooses (hybrid_ode_torch/ops/fused_rk4.py).
// The cluster route's product variant follows from the widths
// (cluster_products).
extern "C" int fused_rk4_bwd(const float* traj, const float* gbar, const float* ts,
                             const float* meal, const float* tvns, const float* ctx,
                             const float* wpack, const float* pvec, const int* cidx,
                             float* ybar0, float* dp, float* dctx, float* dflat,
                             float* partials, float* scratch, int B, int T, int C,
                             int in_pad, int H, int n_layers, int substeps, int n_cp,
                             int abs_mode, int bf16, int grid, int n_w, int tw, void* stream) {
  const int products = tw ? cluster_products(in_pad, H, tw) : PRODUCTS_NONE;
  if (B < 1 || T < 1 || C < 0 || H < 4 || H % 4 != 0 || in_pad % 4 != 0 ||
      in_pad < NF + (n_cp ? 0 : C) || n_layers < 1 || substeps < 1 ||
      n_cp < 0 || n_cp > NP || (n_cp && n_cp != C) || (C && (!ctx || !dctx)) ||
      (n_cp && !cidx) || grid < 1 ||
      n_w != in_pad * H + (n_layers - 1) * H * H + H * NOUT + n_layers * H + NOUT ||
      (long long)T * NS * B > 0x7fffffffLL ||  // int offsets
      tw < 0 || tw > WTILE || tw % 4 != 0 ||
      (tw && (grid != (B + tw - 1) / tw || products == PRODUCTS_NONE)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tw) {
    ClusterLayout cl;
    if (bwd_cluster_layout(C, in_pad, H, n_layers, substeps, tw, &cl))
      return (int)cudaErrorInvalidValue;
    auto go = [&](auto fn) {
      return fn(cl, grid, s, traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx, ybar0, dp, dctx,
                partials, scratch, B, T, C, in_pad, H, n_layers, substeps, n_cp, abs_mode, n_w,
                tw);
    };
    if (products == PRODUCTS_NARROW)
      err = bf16 ? go(launch_cluster<true, PRODUCTS_NARROW>)
                 : go(launch_cluster<false, PRODUCTS_NARROW>);
    else
      err = bf16 ? go(launch_cluster<true, PRODUCTS_WIDE>)
                 : go(launch_cluster<false, PRODUCTS_WIDE>);
  } else {
    Layout lay;
    if (bwd_layout(C, in_pad, H, n_layers, substeps, &lay)) return (int)cudaErrorInvalidValue;
    err = FUSED_RK4_BWD_DISPATCH(
        launch, bf16, lay, lay, grid, s, traj, gbar, ts, meal, tvns, ctx, wpack, pvec, cidx,
        ybar0, dp, dctx, partials, scratch, B, T, C, in_pad, H, n_layers, substeps, n_cp,
        abs_mode, n_w);
  }
  if (err != cudaSuccess) return (int)err;
  sum_rows<<<(n_w + 255) / 256, 256, 0, s>>>(partials, grid, n_w, dflat);
  return (int)cudaGetLastError();
}
