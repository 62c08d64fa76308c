// Shared by the three fused RK4 kernels (fused_rk4_fwd.cu and both adjoints,
// fused_rk4_bwd.cu and fused_rk4_bwd_vjp.cu): a 64-sample tile, MLP weights
// staged layer by layer in shared memory, and the register-tiled forward
// products on them (each adjoint keeps its own transposed products).
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

#pragma once

#include <cuda_pipeline.h>

#include "fused_rk4_common.cuh"

namespace fused_rk4 {

constexpr int WTILE = 64;           // samples per tile
constexpr int WSQ = WTILE / 4;      // sample quads
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block can get on sm_90
constexpr int DENSE_UNROLL = 8;     // k steps per trip of a product's loop (4: 3% slower)
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

// For every tile t of the (N x WTILE) product
//   acc[i][j] = sum_k W[k * N + n0 + i] * in[k][4 sq + j],  k ascending,
// calls tag = pre(t) before the sum and epi(t, n0, sq, rows, acc, tag) after
// it; rows (RT, or 4 in the last tile when RT = 8 and N % 8 = 4) of acc are
// valid. W is (K, N) row-major, N a multiple of 4; `in` is [K][WTILE].
// BF16: `in` is read rounded (the weights arrive rounded).
template <bool BF16, int RT, class Pre, class Epi>
__device__ __forceinline__ void dense_w(const float* __restrict__ W, const float* in, int K,
                                        int N, Pre pre, Epi epi) {
  static_assert(RT == 4 || RT == 8, "row tile");
  const int n4 = N / 4;
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
            const float4 w = w4[k * n4 + q];
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
    if (full) rows(Int<0>(), Int<RT>());
    else rows(Int<0>(), Int<4>());
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

}  // namespace fused_rk4
