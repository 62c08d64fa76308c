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
// launch, not once a stage), and computes its rows for all tw samples in the
// product variant built for its tile width (Products, below; the library
// picks it, cluster_products). It writes them into its own copy of the
// layer's buffer; the Exchange copies that block into every other CTA (one
// bulk copy each through distributed shared memory, completing on the
// receiver's mbarrier), so a product costs one wait on local bytes, not a
// cluster barrier. The per-sample work (mechanistic drift, RK4 state, stage
// sums, the 8-row last layer) runs redundantly in every CTA on identical
// operands, so it needs no exchange. The variants are built for the widths
// of the shipped models only (H = 128, in_pad 16 or 32); other widths take
// the wide route.
//   * Why by N and never by K: a split of the contraction would split the sum
//     above into partial sums added in another order. Split by N, every output
//     is the same k-ascending fmaf chain as on the wide route, so trajectories
//     and adjoints equal the wide route's bitwise (its dead lanes add exact
//     zeros to the weight cotangents), whichever variant computes it.
//   * What bounds a product: its chains, then the SM's shared-memory loads.
//     A 128-deep output is 128 dependent fmaf (about 4.5 cycles each: 570
//     cycles); one warp alone issues about an instruction every 2.5 cycles;
//     a warp's 16-byte shared load takes 4 cycles of the SM's load path where
//     a quarter-warp reads 8 addresses, 2 where it reads one. Products of one
//     row x 4 samples a thread (a scalar weight and a float4 of samples a k)
//     waited on shared memory at every k: 3.7k cycles a 128-deep product at
//     tw = 32, 3.2k at tw = 4. The tiled ones load 4 k of a weight row and 4 k
//     of a sample per 16-byte load, unrolled with compile-time offsets and
//     loaded ahead: 'narrow' (an output a thread, 64 threads at tw = 4) runs
//     near its chains, 0.87k cycles; 'wide' (2 x 2 tiles, 128 threads at
//     tw = 32) at the load path, 2.0k. Measured on an H100 with clock64
//     probes (kernel_probes.py, PERF.md section 6): a forward stage 12.7k
//     cycles at tw = 32 (20.6k with one row a thread: 0.4k drift, 0.8k layer
//     0, 3 x 2.0k hidden, 4 x 1.0k exchanges, 1.2k last layer, 0.4k the rest)
//     and 9.0k at tw = 4 (18.4k), where the exchanges are 3.7k of it.
//   * Shared memory (CTA, floats): the weight slices, slice_floats of each
//     forward product's ([rows][K + 4]), the whole last layer ((H + 4) x 8)
//     and the CTA's biases, then tw x (in_pad + 2 H + 8) of activations and 6
//     of mbarriers; at H = 128, 16 context features, L = 4: 32 KB of weights,
//     76 KB of activations at tw = 64. The adjoint adds its transposed slices
//     (28 KB), the per-sample state and phase 3's ring (fused_rk4_bwd.cu).

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <type_traits>

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

// Cycle probes of the cluster route: built with -DFUSED_RK4_PROBE=1, thread 0
// of a launch's first CTA sums the clock64 cycles of each part of a stage in
// shared memory and, at the end, adds them to probe_cycles[part] (and the
// part's count to probe_calls[part]); a part ends at a block barrier, one more
// where the code has none. kernel_probes.py at the repository's root reads
// them. The default, 0, compiles to no code at all.
#ifndef FUSED_RK4_PROBE
#define FUSED_RK4_PROBE 0
#endif
enum ProbePart {
  PP_DRIFT,     // the stage's drift and features, to the barrier after them
  PP_LAYER0,    // the first product (K = in_pad)
  PP_HIDDEN,    // a hidden product (K = H)
  PP_EXCHANGE,  // a product's exchange: publish, then wait for the peers' rows
  PP_LAST,      // the last layer (8 rows, K = H)
  PP_STAGE,     // the stage's closing barrier, its RK4 sum, the interval's bookkeeping
  PP_T_FIRST,   // phase 2: the first transposed product (K = 8)
  PP_T_HIDDEN,  // phase 2: a transposed hidden product (K = H)
  PP_T_INPUT,   // phase 2: the product into the features' cotangent (N = in_pad)
  PP_T_EXCHANGE,
  PP_T_STAGE,   // phase 2: the stage's mechanistic transpose and barriers
  PP_OUTER,     // phase 3, whole, with its barriers
  PP_N
};
#if FUSED_RK4_PROBE
__device__ unsigned long long probe_cycles[PP_N], probe_calls[PP_N];
#endif

struct Probes {
#if FUSED_RK4_PROBE
  long long t;
  unsigned long long* sum;  // [2][PP_N]: cycles, then counts
  __device__ __forceinline__ bool on() const { return blockIdx.x == 0 && threadIdx.x == 0; }
#endif
  __device__ __forceinline__ void start() {
#if FUSED_RK4_PROBE
    __shared__ unsigned long long sums[2 * PP_N];
    sum = sums;
    if (on())
      for (int i = 0; i < 2 * PP_N; ++i) sum[i] = 0;
    t = clock64();
#endif
  }
  // Ends `part` here; with `sync`, after a block barrier of its own.
  __device__ __forceinline__ void lap(int part, bool sync = true) {
#if FUSED_RK4_PROBE
    if (sync) __syncthreads();
    if (on()) {
      const long long now = clock64();
      sum[part] += (unsigned long long)(now - t);
      sum[PP_N + part] += 1;
      t = now;
    }
#endif
  }
  __device__ __forceinline__ void finish() const {
#if FUSED_RK4_PROBE
    if (on())
      for (int i = 0; i < PP_N; ++i) {
        probe_cycles[i] += sum[i];
        probe_calls[i] += sum[PP_N + i];
      }
#endif
  }
};

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

// For every tile t of the (N x WTILE) product
//   acc[i][j] = sum_k W[k * N + n0 + i] * in[k][4 sq + j],  k ascending,
// calls tag = pre(t) before the sum and epi(t, n0, sq, rows, acc, tag) after
// it; rows (RT, or 4 in the last tile when RT = 8 and N % 8 = 4) of acc are
// valid. W is (K, N) row-major (N a multiple of 4); `in` is [K][WTILE].
// BF16: `in` is read rounded (the weights arrive rounded).
template <bool BF16, int RT, class Pre, class Epi>
__device__ __forceinline__ void dense_w(const float* __restrict__ W, const float* in, int K,
                                        int N, Pre pre, Epi epi) {
  static_assert(RT == 4 || RT == 8, "row tile");
  const int l4 = N / 4;
  const int n_tiles = ((N + RT - 1) / RT) * WSQ;
  for (int t = threadIdx.x; t < n_tiles; t += NTHREADS) {
    const int sq = t % WSQ, n0 = (t / WSQ) * RT;
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
          const float4 a = a4[k * WSQ];
          av[0] = operand<BF16>(a.x); av[1] = operand<BF16>(a.y);
          av[2] = operand<BF16>(a.z); av[3] = operand<BF16>(a.w);
        }
#pragma unroll
        for (int i = R0; i < R1; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
      }
    };
    if (full) {
      rows(Int<0>(), Int<RT>());
    } else if constexpr (RT > 4) {
      rows(Int<0>(), Int<4>());
    }
    epi(t, n0, sq, full ? RT : 4, acc, tag);
  }
}

struct NoTag {
  __device__ __forceinline__ int operator()(int) const { return 0; }
};

// out[n0 + i][4 sq ..] = v[i][..] for i < rows: a tile into an [N][WTILE] buffer.
template <int RT>
__device__ __forceinline__ void store_tile(float* out, int n0, int sq, int rows,
                                           const float (&v)[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < rows)
      reinterpret_cast<float4*>(out)[(n0 + i) * WSQ + sq] =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// v[i][..] = relu(v[i][..] + bias[n0 + i]); returns bit 4 i + j set where the
// result is > 0 (NaN propagates, as max(x, 0); its bit is clear).
template <int RT>
__device__ __forceinline__ unsigned bias_relu(float (&v)[RT][4], const float* __restrict__ bias,
                                              int n0, int rows) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < rows) {
      const float b = __ldg(bias + n0 + i);
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

// ---- The cluster route's products (PRODUCTS_NARROW, PRODUCTS_WIDE below).
// The wide route's dense_w, dense_out and outer_w do not use them.

// Floats a row of a k-contiguous weight slice takes: K and 4 more, so that
// the float4 at k of rows n and n + 1 lie 4 banks apart.
__host__ __device__ constexpr int slice_ld(int K) { return K + 4; }

// Floats of a CTA's slice of a K x N product: [n][slice_ld(K)] for its rows
// of N (load_rows).
__host__ __device__ inline int slice_floats(int K, int N) { return slice_ld(K) * split_max(N); }

// W[k * ldw + lo + n] for k < K, n < n_own into dst[n][slice_ld(K)]: a CTA's
// rows of a layer, each k-contiguous, read once a launch.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ W, int ldw, int K,
                                          int lo, int n_own) {
  for (int i = threadIdx.x; i < K * n_own; i += NTHREADS)
    dst[(i % n_own) * slice_ld(K) + i / n_own] = W[(i / n_own) * ldw + lo + i % n_own];
}

// A thread tile of the cluster route's products: RT consecutive rows x CT
// samples tw / CT apart (samples s0 + j tw / CT, j < CT), so that consecutive
// lanes take consecutive samples in every load and store of a tile. The sg =
// tw / CT tiles of a row group lie on P lanes, P the power of 2 >= sg (lanes
// past sg idle), so that a thread finds its tile with a shift and a mask. A
// variant is built only where that takes at most NTHREADS lanes
// (cluster_products): a thread has one tile at most.
template <int RT_, int CT_>
struct Tile {
  static constexpr int RT = RT_, CT = CT_;
  bool valid;       // this thread has a tile of the product
  int idx, n0, s0;  // its index (row group x sg + s0), first row, first sample
  __device__ static Tile at(int N, int tw) {
    const int sg = tw / CT, lg = 32 - __clz(sg - 1);
    const int r = threadIdx.x >> lg, c = threadIdx.x & ((1 << lg) - 1);
    return {c < sg && r < N / RT, r * sg + c, r * RT, c};
  }
  // Phase 1 of the adjoint keeps a tile's ReLU bits (bit CT i + j) for phase
  // 2, whose transposed product of the same width has the same tiles. A tile
  // of one output shares one word with its warp (word idx / 32; 'narrow' is
  // taken only where a product's tiles fill whole warps: tw a power of 2); a
  // larger tile has word idx of its own: at most 4 tw words of a 16-row slice.
  __device__ static void put_mask(unsigned* mk, int t, unsigned bits) {
    static_assert(RT * CT == 1 || RT * CT >= 4, "a ReLU mask: a warp's ballot, or a word a tile");
    if constexpr (RT * CT == 1) {
      const unsigned w = __ballot_sync(0xffffffffu, bits & 1u);
      if ((threadIdx.x & 31) == 0) mk[t / 32] = w;
    } else {
      mk[t] = bits;
    }
  }
  __device__ static unsigned mask(const unsigned* mk, int t) {
    if constexpr (RT * CT == 1) return (mk[t / 32] >> (t & 31)) & 1u;
    else return mk[t];
  }
};

// The cluster route's product on its tiled paths: in the thread that owns
// Tile t of the (N x tw) output (Tile::at), tag = pre(t), then
//   acc[i][j] = sum_k W[(n0 + i) * slice_ld(K) + k] * in(k, s0 + j tw / CT),
// k ascending from 0 by fmaf (the chain every route takes), then
// epi(t, n0, s0, acc, tag). W holds the product's rows k-contiguous
// (load_rows), so one float4 brings 4 k of a row. `in` is [K][tw] or, with
// ILV, [K / 4][tw][4] (cl_store_ilv), where one float4 brings 4 k of a
// sample. Lanes that share rows read one weight address; consecutive lanes
// read consecutive samples. K and N are compile-time: the loop is unrolled
// whole, every weight address is an immediate offset, and each quad of k is
// loaded AHEAD quads before its fmaf, so the chain does not wait on shared
// memory (a loop that loads one k at a time waited about 28 cycles a k). BF16: `in`
// is read rounded.
template <bool BF16, int K, int N, class T, bool ILV, class Pre, class Epi>
__device__ __forceinline__ void cl_dense(const float* W, const float* in, int tw, Pre pre,
                                         Epi epi) {
  constexpr int RT = T::RT, CT = T::CT, Q = K / 4, LD4 = slice_ld(K) / 4, AHEAD = 2, NB = AHEAD + 1;
  static_assert(K % 4 == 0 && N % RT == 0, "product widths");
  const T tile = T::at(N, tw);
  if (tile.valid) {
    const int t = tile.idx, n0 = tile.n0, s0 = tile.s0, ss = tw / CT;
    const float4* w4 = reinterpret_cast<const float4*>(W) + n0 * LD4;
    const float* a = in + s0;
    const auto tag = pre(t);
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
    float4 wq[NB][RT];
    float aq[NB][4][CT];
    auto load = [&](int q) {
#pragma unroll
      for (int i = 0; i < RT; ++i) wq[q % NB][i] = w4[i * LD4 + q];
      if constexpr (ILV) {
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const float4 x = reinterpret_cast<const float4*>(in)[q * tw + s0 + j * ss];
          aq[q % NB][0][j] = x.x; aq[q % NB][1][j] = x.y;
          aq[q % NB][2][j] = x.z; aq[q % NB][3][j] = x.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < CT; ++j) aq[q % NB][kk][j] = a[(4 * q + kk) * tw + j * ss];
      }
    };
#pragma unroll
    for (int q = 0; q < AHEAD && q < Q; ++q) load(q);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q + AHEAD < Q) load(q + AHEAD);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 wv = wq[q % NB][i];
          const float w = kk == 0 ? wv.x : kk == 1 ? wv.y : kk == 2 ? wv.z : wv.w;
#pragma unroll
          for (int j = 0; j < CT; ++j)
            acc[i][j] = fmaf(w, operand<BF16>(aq[q % NB][kk][j]), acc[i][j]);
        }
    }
    epi(t, n0, s0, acc, tag);
  }
}

// x, opaque to the compiler: what a product computes from it (its thread's
// Tile) is computed there, not hoisted into registers held across the stage
// loops. The adjoint's cluster kernel, which has no register to spare, passes
// its tile width so (spilling otherwise: its 2 x 2 products took 3.5k cycles
// for 2.0k in the forward); the forward, which has them, lets it be hoisted.
__device__ __forceinline__ int unhoisted(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// v[i][j] = relu(v[i][j] + bias[n0 + i]) as bias_relu takes it; returns bit
// CT i + j set where the result is > 0.
template <int RT, int CT>
__device__ __forceinline__ unsigned cl_bias_relu(float (&v)[RT][CT], const float* bias, int n0) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float b = bias[n0 + i];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      float x = v[i][j] + b;
      x = x < 0.f ? 0.f : x;
      v[i][j] = x;
      bits |= (x > 0.f ? 1u : 0u) << (CT * i + j);
    }
  }
  return bits;
}

// out[(r0 + i) * tw + s0 + j tw / CT] = v[i][j]: a Tile into a [rows][tw] buffer.
template <int RT, int CT>
__device__ __forceinline__ void cl_store(float* out, int tw, int r0, int s0,
                                         const float (&v)[RT][CT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) out[(r0 + i) * tw + s0 + j * (tw / CT)] = v[i][j];
}

// The same into a [rows / 4][tw][4] buffer, which keeps 4 consecutive rows of
// a sample together: row r of sample s at (r / 4) 4 tw + 4 s + r % 4 (r0 a
// multiple of RT). A CTA's rows [lo, lo + nl) of it (lo, nl multiples of 4)
// are the floats [lo tw, (lo + nl) tw), as in a [rows][tw] buffer, so the
// Exchange copies them alike.
template <int RT, int CT>
__device__ __forceinline__ void cl_store_ilv(float* out, int tw, int r0, int s0,
                                             const float (&v)[RT][CT]) {
  static_assert(RT == 1 || RT == 2 || RT == 4, "row tile");
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    float* p = out + (r0 / 4) * 4 * tw + 4 * (s0 + j * (tw / CT)) + r0 % 4;
    if constexpr (RT == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    else if constexpr (RT == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0][j], v[1][j]);
    else *p = v[0][j];
  }
}

// The cluster route's product variants; a kernel instance holds one. Both
// are built for H = TILED_H with in_pad 16 or 32, the shipped models' widths:
//   PRODUCTS_NARROW   cl_dense on Tile<1, 1>, an output a thread;
//   PRODUCTS_WIDE     Tile<2, 2>.
// Both keep k-contiguous weight rows (load_rows) and the hidden layers'
// activations and cotangents 4 rows of a sample together (cl_store_ilv); the
// features, the residual and dX stay [rows][tw]. PRODUCTS_NONE: no cluster
// route for the widths.
enum Products { PRODUCTS_NONE, PRODUCTS_NARROW, PRODUCTS_WIDE };
constexpr int TILED_H = 128;                   // hidden width the variants are built for
constexpr int TILED_NL = TILED_H / CLUSTER;    // rows of it a CTA owns
static_assert(TILED_H % (4 * CLUSTER) == 0, "a CTA's rows are whole quads");
// The widest tile that takes 'narrow': one output a thread beats 2 x 2 tiles
// up to 8 samples (PERF.md section 6). Its tile widths, 4 and 8, are powers
// of 2 whose outputs of a CTA's rows fill whole warps of its threads.
constexpr int WIDEST_NARROW_TILE = 8;
static_assert(WIDEST_NARROW_TILE <= 8 && TILED_NL * WIDEST_NARROW_TILE <= NTHREADS, "narrow tiles");
static_assert((TILED_NL / 2) * (WTILE / 2) <= NTHREADS, "a 2 x 2 tile a thread at tw = WTILE");

// The variant that runs these widths at tile width tw, or PRODUCTS_NONE.
__host__ __device__ inline int cluster_products(int in_pad, int H, int tw) {
  if (H != TILED_H || (in_pad != 16 && in_pad != 32)) return PRODUCTS_NONE;
  return tw <= WIDEST_NARROW_TILE ? PRODUCTS_NARROW : PRODUCTS_WIDE;
}

// The thread tile of variant V's products of N rows: an output a thread on
// 'narrow' and in the product into dX (N = in_pad / CLUSTER); on 'wide' 2 x 2
// for the 16-row products and 2 x 1 for the 8-row last layer, so that each
// takes 4 warps at tw = 32.
template <int V, int N>
using TileOf = typename std::conditional<
    V == PRODUCTS_NARROW || N < NOUT, Tile<1, 1>,
    typename std::conditional<N == NOUT, Tile<2, 1>, Tile<2, 2>>::type>::type;

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

#if FUSED_RK4_PROBE
// out[0 .. PP_N) = the probes' cycles, out[PP_N .. 2 PP_N) their counts,
// since the last call; then zeroes them.
extern "C" int fused_rk4_probes(long long* out) {
  unsigned long long zero[fused_rk4::PP_N] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (!err) err = cudaMemcpyFromSymbol(out, fused_rk4::probe_cycles, sizeof(zero));
  if (!err) err = cudaMemcpyFromSymbol(out + fused_rk4::PP_N, fused_rk4::probe_calls, sizeof(zero));
  if (!err) err = cudaMemcpyToSymbol(fused_rk4::probe_cycles, zero, sizeof(zero));
  if (!err) err = cudaMemcpyToSymbol(fused_rk4::probe_calls, zero, sizeof(zero));
  return (int)err;
}
#endif
