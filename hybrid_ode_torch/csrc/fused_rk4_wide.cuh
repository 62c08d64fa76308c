// Shared by the three fused RK4 kernels (fused_rk4_fwd.cu and both adjoints,
// fused_rk4_bwd.cu and fused_rk4_bwd_vjp.cu): a 64-sample tile, MLP weights
// staged layer by layer in shared memory, and the register-tiled forward
// products on them (each adjoint keeps its own transposed products). The
// forward and the hand adjoint also take a second partition of a tile on
// these same products, the cluster route (below).
//
// The invariant is the accumulation order, not the tiling: every
// pre-activation is
//   acc = 0; for k ascending: acc = fmaf(W[k][n], in[k][s], acc); acc + bias[n]
// then the ReLU, whatever thread computes it and wherever W[k][n] is read
// from, so the adjoints rebuild bitwise the forward's pre-activations and
// ReLU masks.
//
// Weights: one block per SM holds two buffers of one layer each (64 KB at
// H = 128). While layer l multiplies out of one buffer, cp.async (16 bytes
// per thread and copy) brings layer l + 1 into the other; one barrier per
// layer both publishes the copy and orders the activations. Each layer is
// therefore read from L2 once per stage and tile, in bulk, not once per k and
// warp. Where two layers do not fit beside the activations (route
// `staged = 0`), the same products read the weights from global memory.
//
// Products: a thread owns RT output rows x 4 samples (RT = 8 when that still
// gives every thread a tile, i.e. H >= 128, else 4). Per k it reads RT / 4
// float4 of weights (the same address for the 16 lanes that share its rows: a
// broadcast) and one float4 of activations (16 lanes, 256 contiguous bytes).
//
// The cluster route (small batches: the forward's and the hand adjoint's
// `_kernel_cluster`). One tile of tw = min(64, B rounded up to 4) samples runs
// on a thread-block cluster of CLUSTER CTAs on neighbouring SMs instead of on
// one SM. Every product is split by its output rows (N): CTA r owns rows
// [split_lo(N, r), split_lo(N, r + 1)) of each hidden layer (and of the
// adjoint's input cotangents), keeps the slice W[:, rows] of those layers and
// its biases in shared memory for the whole launch (read from L2 once a
// launch, not once a stage), and computes its rows for all tw samples with
// dense_w on that row range (RT = 1: one row x 4 samples a thread, so that a
// 16-row slice still gives 128 threads a tile at tw = 32). It writes them
// into its own copy of the layer's buffer; the Exchange copies that block
// into every other CTA (one bulk copy each through distributed shared
// memory, completing on the receiver's mbarrier), so a product costs one
// wait on local bytes, not a cluster barrier. The per-sample work
// (mechanistic drift, RK4 state, stage sums, the 8-row last layer) runs
// redundantly in every CTA on identical operands, so it needs no exchange.
//   * Why by N and never by K: a split of the contraction would split the sum
//     above into partial sums added in another order. Split by N, every output
//     is the same k-ascending fmaf chain as on the wide route, so trajectories
//     and adjoints equal the wide route's bitwise (its dead lanes add exact
//     zeros to the weight cotangents).
//   * What bounds it: latency, not the card's peak. A product is a chain of K
//     dependent fmaf per output with one or two warps a scheduler to hide it,
//     and each thread reads a float4 of activations from shared memory for
//     4 fmaf; then one exchange. Measured on an H100 at tw = 32, H = 128:
//     about 3.9k cycles a 128-deep product, 0.8-1k cycles an exchange,
//     20k cycles a forward stage (clock64 probes), against 512 cycles of
//     dependent fmaf a product.
//   * Shared memory (CTA, floats): the weight slices, (in_pad + (L-1) H) x
//     ceil(H / CLUSTER) of the forward products, the whole last layer (H x 8)
//     and the CTA's biases, then tw x (in_pad + 2 H + 8) of activations and 6
//     of mbarriers; at H = 128, 16 context features, L = 4: 30 KB of weights,
//     76 KB of activations at tw = 64. The adjoint adds its transposed slices
//     (27 KB), the per-sample state and phase 3's ring (fused_rk4_bwd.cu).

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "fused_rk4_common.cuh"

namespace fused_rk4 {

constexpr int WTILE = 64;           // samples per tile
constexpr int WSQ = WTILE / 4;      // sample quads
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block can get on sm_90
constexpr int DENSE_UNROLL = 8;     // k steps per trip of a product's loop (4: 3% slower)
constexpr int CLUSTER = 8;          // CTAs per tile on the cluster route (the portable size)
static_assert(NTHREADS / WTILE * 2 == NOUT, "dense_out gives every thread two of the NOUT rows");

// Timing cuts: built with -DFUSED_RK4_CUT=<bits> a kernel leaves work out, and
// its time against the whole kernel's says what that work costs
// (kernel_cuts.py at the repository's root builds and times them). Its outputs
// are then wrong. The default, 0, compiles to the code without any of it.
//   1  the adjoint does not save its operands to scratch (phases 1 and 2)
//   2  the adjoint leaves out its reverse sweep (phase 2)
//   4  the adjoint leaves out the weight and bias cotangents (phase 3)
//   8  dense_w loads its operands from shared memory only at every 4th k
#ifndef FUSED_RK4_CUT
#define FUSED_RK4_CUT 0
#endif
constexpr bool CUT_SAVES = FUSED_RK4_CUT & 1;
constexpr bool CUT_SWEEP = FUSED_RK4_CUT & 2;
constexpr bool CUT_OUTER = FUSED_RK4_CUT & 4;
constexpr bool CUT_LOADS = FUSED_RK4_CUT & 8;

// Floats of layer l's weights, and their offset in the packed layout.
__host__ __device__ inline int layer_floats(int l, int in_pad, int H, int L) {
  return l == 0 ? in_pad * H : (l < L ? H * H : H * NOUT);
}
__host__ __device__ inline int layer_offset(int l, int in_pad, int H) {
  return l == 0 ? 0 : in_pad * H + (l - 1) * H * H;
}
// Floats of the largest layer: what one staging buffer must hold.
inline int max_layer_floats(int in_pad, int H, int L) {
  int m = in_pad * H > H * NOUT ? in_pad * H : H * NOUT;
  return (L > 1 && H * H > m) ? H * H : m;
}

// dst[0..n) <- src[0..n), n a multiple of 4, as 16-byte asynchronous copies
// spread over the block. Completed by Ring::arrive.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * NTHREADS)
    __pipeline_memcpy_async(dst + i, src + i, 16);
}

// Two shared-memory buffers of `cap` floats. One is in use; `incoming()` is
// the other, free to be filled (asynchronously) since the last `arrive()`.
// `arrive()` waits for this thread's copies, meets the block at a barrier
// (so every thread's copies are visible and nobody still reads the buffer
// that becomes free) and hands out the filled buffer.
struct Ring {
  float* buf;
  int cap;
  int cur;
  __device__ __forceinline__ void init(float* b, int c) { buf = b; cap = c; cur = 1; }
  __device__ __forceinline__ float* incoming() const { return buf + (cur ^ 1) * cap; }
  __device__ __forceinline__ void commit() const { __pipeline_commit(); }
  __device__ __forceinline__ const float* arrive() {
    __pipeline_wait_prior(0);
    __syncthreads();
    cur ^= 1;
    return buf + cur * cap;
  }
};

// Start bringing a layer's n floats into the ring (STAGED), or nothing.
template <bool STAGED>
__device__ __forceinline__ void fetch_weights(Ring& ring, const float* src, int n) {
  if constexpr (STAGED) {
    copy_async(ring.incoming(), src, n);
    ring.commit();
  }
}

// The layer last fetched, after a block barrier: its staged copy, or `src`.
template <bool STAGED>
__device__ __forceinline__ const float* weights_ready(Ring& ring, const float* src) {
  if constexpr (STAGED) {
    return ring.arrive();
  } else {
    __syncthreads();
    return src;
  }
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// For every tile t of the (N x 4 sqn) product
//   acc[i][j] = sum_k W[k * ldw + n0 + i] * in[k][4 sq + j],  k ascending,
// calls tag = pre(t) before the sum and epi(t, n0, sq, rows, acc, tag) after
// it; rows (RT, or 4 in the last tile when RT = 8 and N % 8 = 4) of acc are
// valid. W is (K, N) with rows of ldw floats (N and ldw multiples of 4 unless
// RT = 1); `in` is [K][4 sqn]. BF16: `in` is read rounded (the weights arrive
// rounded).
template <bool BF16, int RT, class Pre, class Epi>
__device__ __forceinline__ void dense_w(const float* __restrict__ W, int ldw, const float* in,
                                        int sqn, int K, int N, Pre pre, Epi epi) {
  static_assert(RT == 1 || RT == 4 || RT == 8, "row tile");
  const int l4 = ldw / 4;
  const int n_tiles = ((N + RT - 1) / RT) * sqn;
  for (int t = threadIdx.x; t < n_tiles; t += NTHREADS) {
    const int sq = t % sqn, n0 = (t / sqn) * RT;
    const bool full = n0 + RT <= N;
    const float4* w4 = reinterpret_cast<const float4*>(W + n0);
    const float4* a4 = reinterpret_cast<const float4*>(in) + sq;
    const auto tag = pre(t);
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // rows [R0, R1) of the tile, every k
    auto rows = [&](auto r0, auto r1) {
      constexpr int R0 = decltype(r0)::value, R1 = decltype(r1)::value;
      float wv[RT], av[4];
#pragma unroll DENSE_UNROLL
      for (int k = 0; k < K; ++k) {
        if (!CUT_LOADS || k % 4 == 0) {
#pragma unroll
          for (int q = R0 / 4; q < R1 / 4; ++q) {
            const float4 w = w4[k * l4 + q];
            wv[4 * q] = w.x; wv[4 * q + 1] = w.y; wv[4 * q + 2] = w.z; wv[4 * q + 3] = w.w;
          }
          const float4 a = a4[k * sqn];
          av[0] = operand<BF16>(a.x); av[1] = operand<BF16>(a.y);
          av[2] = operand<BF16>(a.z); av[3] = operand<BF16>(a.w);
        }
#pragma unroll
        for (int i = R0; i < R1; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
      }
    };
    if constexpr (RT == 1) {
      // One row (the cluster route): one warp a scheduler, so every k would
      // wait on shared memory. Two register sets alternate: the next
      // DENSE_UNROLL k's operands load while these multiply.
      const float* w = W + n0;
      float wa[DENSE_UNROLL], wb[DENSE_UNROLL];
      float4 xa[DENSE_UNROLL], xb[DENSE_UNROLL];
      auto load = [&](float (&wv)[DENSE_UNROLL], float4 (&xv)[DENSE_UNROLL], int k0) {
#pragma unroll
        for (int u = 0; u < DENSE_UNROLL; ++u) {
          wv[u] = w[(k0 + u) * ldw];
          xv[u] = a4[(k0 + u) * sqn];
        }
      };
      auto mul = [&](float wk, float4 xk) {
        acc[0][0] = fmaf(wk, operand<BF16>(xk.x), acc[0][0]);
        acc[0][1] = fmaf(wk, operand<BF16>(xk.y), acc[0][1]);
        acc[0][2] = fmaf(wk, operand<BF16>(xk.z), acc[0][2]);
        acc[0][3] = fmaf(wk, operand<BF16>(xk.w), acc[0][3]);
      };
      auto mul_all = [&](const float (&wv)[DENSE_UNROLL], const float4 (&xv)[DENSE_UNROLL]) {
#pragma unroll
        for (int u = 0; u < DENSE_UNROLL; ++u) mul(wv[u], xv[u]);
      };
      const int kg = K / DENSE_UNROLL * DENSE_UNROLL;  // k in whole groups, then the rest
      if (kg) load(wa, xa, 0);
      for (int k0 = 0; k0 < kg; k0 += 2 * DENSE_UNROLL) {
        const bool second = k0 + DENSE_UNROLL < kg;
        if (second) load(wb, xb, k0 + DENSE_UNROLL);
        mul_all(wa, xa);
        if (!second) break;
        if (k0 + 2 * DENSE_UNROLL < kg) load(wa, xa, k0 + 2 * DENSE_UNROLL);
        mul_all(wb, xb);
      }
      for (int k = kg; k < K; ++k) mul(w[k * ldw], a4[k * sqn]);
    } else if (full) {
      rows(Int<0>(), Int<RT>());
    } else if constexpr (RT > 4) {
      rows(Int<0>(), Int<4>());
    }
    epi(t, n0, sq, full ? RT : 4, acc, tag);
  }
}

// The wide route's product: all N rows of W (K, N) row-major on a WTILE-sample tile.
template <bool BF16, int RT, class Pre, class Epi>
__device__ __forceinline__ void dense_w(const float* __restrict__ W, const float* in, int K,
                                        int N, Pre pre, Epi epi) {
  dense_w<BF16, RT>(W, N, in, WSQ, K, N, pre, epi);
}

struct NoTag {
  __device__ __forceinline__ int operator()(int) const { return 0; }
};

// out[n0 + i][4 sq ..] = v[i][..] for i < rows: a tile into an [N][4 sqn] buffer.
template <int RT>
__device__ __forceinline__ void store_tile(float* out, int sqn, int n0, int sq, int rows,
                                           const float (&v)[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < rows)
      reinterpret_cast<float4*>(out)[(n0 + i) * sqn + sq] =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// The same into an [N][WTILE] buffer.
template <int RT>
__device__ __forceinline__ void store_tile(float* out, int n0, int sq, int rows,
                                           const float (&v)[RT][4]) {
  store_tile<RT>(out, WSQ, n0, sq, rows, v);
}

// v[i][..] = relu(v[i][..] + bias[n0 + i]); returns bit 4 i + j set where the
// result is > 0 (NaN propagates, as max(x, 0); its bit is clear). SMEM: the
// biases lie in shared memory (the cluster route), else in global memory.
template <int RT, bool SMEM = false>
__device__ __forceinline__ unsigned bias_relu(float (&v)[RT][4], const float* __restrict__ bias,
                                              int n0, int rows) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < rows) {
      float b;
      if constexpr (SMEM) b = bias[n0 + i];
      else b = __ldg(bias + n0 + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = v[i][j] + b;
        x = x < 0.f ? 0.f : x;
        v[i][j] = x;
        bits |= (x > 0.f ? 1u : 0u) << (4 * i + j);
      }
    }
  return bits;
}

// The last layer, R[n][s] = sum_k W[k * NOUT + n] * in[k][s] + bias[n] for
// n < NOUT: every thread takes one sample and two rows, k ascending.
template <bool BF16>
__device__ __forceinline__ void dense_out(const float* __restrict__ W,
                                          const float* __restrict__ bias, const float* in,
                                          float* R, int K) {
  const int s = threadIdx.x % WTILE, r0 = threadIdx.x / WTILE, r1 = r0 + NOUT / 2;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a = operand<BF16>(in[k * WTILE + s]);
    a0 = fmaf(W[k * NOUT + r0], a, a0);
    a1 = fmaf(W[k * NOUT + r1], a, a1);
  }
  R[r0 * WTILE + s] = a0 + __ldg(bias + r0);
  R[r1 * WTILE + s] = a1 + __ldg(bias + r1);
}

// sum_k w[k * ws] * x[k * xs] for k ascending from 0 by fmaf, for NC chains
// at once: the last layer's outputs on the cluster route, where a thread has
// one or two of them and would otherwise wait on shared memory at every k.
// Two register sets alternate as in dense_w.
template <bool BF16, int NC>
__device__ __forceinline__ void dot_chains(const float* const (&w)[NC], int ws,
                                           const float* const (&x)[NC], int xs, int K,
                                           float (&acc)[NC]) {
  constexpr int U = DENSE_UNROLL;
  float wa[NC][U], wb[NC][U], xa[NC][U], xb[NC][U];
  auto load = [&](float (&wv)[NC][U], float (&xv)[NC][U], int k0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wv[c][u] = w[c][(k0 + u) * ws];
        xv[c][u] = x[c][(k0 + u) * xs];
      }
  };
  auto mul = [&](const float (&wv)[NC][U], const float (&xv)[NC][U]) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(wv[c][u], operand<BF16>(xv[c][u]), acc[c]);
  };
  const int kg = K / U * U;
  if (kg) load(wa, xa, 0);
  for (int k0 = 0; k0 < kg; k0 += 2 * U) {
    const bool second = k0 + U < kg;
    if (second) load(wb, xb, k0 + U);
    mul(wa, xa);
    if (!second) break;
    if (k0 + 2 * U < kg) load(wa, xa, k0 + 2 * U);
    mul(wb, xb);
  }
  for (int k = kg; k < K; ++k)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = fmaf(w[c][k * ws], operand<BF16>(x[c][k * xs]), acc[c]);
}

// The last layer on a tile of tw samples (the cluster route): output (n, s)
// by thread n * tw + s and, where 8 tw outputs outnumber the threads, the one
// NTHREADS further on beside it; each sums k ascending from 0, then adds the
// bias (in shared memory), as dense_out does.
template <bool BF16>
__device__ __forceinline__ void dense_out_tw(const float* W, const float* bias, const float* in,
                                             float* R, int K, int tw) {
  const int n_out = NOUT * tw, o = threadIdx.x, o1 = o + NTHREADS;
  if (o1 < n_out) {
    const float* const w[2] = {W + o / tw, W + o1 / tw};
    const float* const x[2] = {in + o % tw, in + o1 % tw};
    float acc[2] = {0.f, 0.f};
    dot_chains<BF16, 2>(w, NOUT, x, tw, K, acc);
    R[o] = acc[0] + bias[o / tw];
    R[o1] = acc[1] + bias[o1 / tw];
  } else if (o < n_out) {
    const float* const w[1] = {W + o / tw};
    const float* const x[1] = {in + o % tw};
    float acc[1] = {0.f};
    dot_chains<BF16, 1>(w, NOUT, x, tw, K, acc);
    R[o] = acc[0] + bias[o / tw];
  }
}

// First of the rows [0, N) that CTA r of a cluster owns on the cluster route.
__host__ __device__ inline int split_lo(int N, int r) { return N * r / CLUSTER; }

// Most rows any CTA owns of N.
__host__ __device__ inline int split_max(int N) { return (N + CLUSTER - 1) / CLUSTER; }

// Floats of a CTA's biases on the cluster route: its rows of each hidden
// layer's, ceil(H / CLUSTER) a layer, then the last layer's 8, padded to 4.
__host__ __device__ inline int cluster_bias_floats(int H, int L) {
  return (L * split_max(H) + NOUT + 3) / 4 * 4;
}

// Those biases into dst: [L][ceil(H / CLUSTER)] from the rows [lo, lo + n_own)
// of bias0's hidden layers, then the last layer's.
__device__ __forceinline__ void load_biases(float* dst, const float* __restrict__ bias0, int H,
                                            int L, int lo, int n_own) {
  const int nh = split_max(H);
  for (int i = threadIdx.x; i < L * n_own; i += NTHREADS)
    dst[(i / n_own) * nh + i % n_own] = bias0[(i / n_own) * H + lo + i % n_own];
  for (int i = threadIdx.x; i < NOUT; i += NTHREADS) dst[L * nh + i] = bias0[L * H + i];
}

// The exchange of the cluster route. A CTA writes its rows of a product into
// its own copy of the buffer; one thread then copies that block (its rows are
// contiguous) into the same place of every other CTA of the cluster with one
// bulk copy each (cp.async.bulk, distributed shared memory), which completes
// its bytes on the receiving CTA's mbarrier for the buffer; a CTA's threads
// wait on their own mbarrier until every other CTA's rows have arrived. Every
// CTA sends its rows after reading its inputs, so the arrival also shows that
// every CTA is done reading the buffer the next product fills: two buffers
// and no cluster barrier a product. A copy's source rows are next rewritten
// two products later, after the sender has waited for the copy to read them.
// NBAR mbarriers, one per receiving buffer, each armed by thread 0 with the
// bytes it expects.
struct Exchange {
  static constexpr int NBAR = 3;
  unsigned bar;     // shared-window address of the mbarriers (8 bytes each)
  unsigned parity;  // bit d: the phase of mbarrier d this thread waits for next

  // In every thread before the first cluster barrier, which publishes it.
  __device__ __forceinline__ void init(unsigned long long* bars) {
    bar = (unsigned)__cvta_generic_to_shared(bars);
    parity = 0;
    if (threadIdx.x == 0) {
      for (int d = 0; d < NBAR; ++d)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar + 8 * d) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  // After this CTA's threads wrote `bytes` at `rows` (a block of the buffer
  // whose mbarrier is d): copy the block into every other CTA.
  __device__ __forceinline__ void publish(const float* rows, int d, int bytes) {
    // the bulk copy (the async proxy) reads what the threads wrote
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned src = (unsigned)__cvta_generic_to_shared(rows);
      const unsigned me = cooperative_groups::this_cluster().block_rank();
      if (bytes > 0)
        for (unsigned r = 0; r < CLUSTER; ++r) {
          if (r == me) continue;
          unsigned dst, rbar;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(src), "r"(r));
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                       : "=r"(rbar) : "r"(bar + 8 * d), "r"(r));
          asm volatile(
              "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];" ::"r"(dst), "r"(src), "r"(bytes), "r"(rbar)
              : "memory");
        }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the copies of two products ago have read their rows, which the next product rewrites
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    }
  }

  // Wait until `bytes` from the other CTAs have arrived on mbarrier d in this phase.
  __device__ __forceinline__ void wait(int d, int bytes) {
    const unsigned b = bar + 8 * d, ph = (parity >> d) & 1u;
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                   : "memory");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(b), "r"(ph)
        : "memory");
    parity ^= 1u << d;
  }

  // Before the CTA leaves: its last copies have read their rows.
  __device__ __forceinline__ void drain() const {
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
};

// A cluster barrier (release / acquire): between the adjoint's phases and,
// with an odd number of hidden layers, after the last layer, whose input
// buffer the next stage's first product fills.
__device__ __forceinline__ void cluster_barrier() { cooperative_groups::this_cluster().sync(); }

// Clusters of CLUSTER CTAs of `kernel`, smem bytes each, that the card runs
// at once: the cluster route's tiles beyond that would wait for a second wave.
template <class Kernel>
inline cudaError_t max_clusters(Kernel kernel, size_t smem, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER, 1, 1);
  config.blockDim = dim3(NTHREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

// W[k * ldw + n] for n in [lo, lo + n_own) of every k < K into dst[k][n_own]:
// a CTA's slice of a layer, read once a launch.
__device__ __forceinline__ void load_slice(float* dst, const float* __restrict__ W, int ldw, int K,
                                           int lo, int n_own) {
  for (int i = threadIdx.x; i < K * n_own; i += NTHREADS)
    dst[i] = W[(i / n_own) * ldw + lo + i % n_own];
}

// Stage c (0..3) of RK4 substep j (jf = j) of the step h from state y at time
// t: the stage's leading NF features of one sample into column `col` of X
// (rows of `ld` floats), and its mechanistic drift into k, which holds the
// last stage's k on entry. Shared by both routes of the forward and of the
// hand adjoint's phase 1, so all rebuild the same states.
__device__ __forceinline__ void stage_features(int c, float jf, float t, float h, float inv_s,
                                               const float (&y)[NS], float (&k)[NS], float m_l,
                                               float m_r, float v_l, float v_r, const float* P,
                                               float* X, int ld, int col) {
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
  X[col] = tt;
#pragma unroll
  for (int s = 0; s < NS; ++s) X[(1 + s) * ld + col] = ys[s];
  X[7 * ld + col] = ys[3];
  X[8 * ld + col] = v;
  mech(ys, m, P, k);
}

// After stage c's MLP: k += its residual (column `col` of R, rows of `ld`
// floats) and the RK4 sum of the substep's stages.
__device__ __forceinline__ void stage_sum(int c, const float* R, int ld, int col, float (&k)[NS],
                                          float (&ksum)[NS]) {
  const float wgt = (c == 1 || c == 2) ? 2.0f : 1.0f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    k[s] += R[s * ld + col];
    ksum[s] = c == 0 ? k[s] : ksum[s] + wgt * k[s];
  }
}

}  // namespace fused_rk4
