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
// Small batches take the cluster route (`fused_rk4_fwd_kernel_cluster`,
// fused_rk4_wide.cuh; the caller chooses the route): a tile of min(64, B
// rounded up to 4) samples on a cluster of 8 CTAs, each owning 16 of the 128
// rows of every hidden layer with its weight slices resident, exchanging its
// rows after each product. At B = 32 the wide route runs one block on one of
// 132 SMs (half its lanes dead) and takes as long as at B = 8192; there the
// bound is not the card's peak but the chain of 128 dependent fmaf a product
// and its exchange, 5 a stage. The kernel is built for H = 128 with in_pad 16
// or 32, in two product variants (template argument V; fused_rk4_wide.cuh,
// Products): 'narrow' (an output a thread) and 'wide' (2 x 2 tiles), which
// the library takes at small and larger tile widths (cluster_products). The
// route's outputs equal the wide route's bitwise in both: every
// pre-activation is the same k-ascending chain.
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
        if (owner)
          stage_features(c, jf, t, h, inv_s, y, k, m_l, m_r, v_l, v_r, P, X, WTILE, tid);
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
        if (owner) stage_sum(c, R, WTILE, tid, k, ksum);
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

// ---- The cluster route (fused_rk4_wide.cuh): one tile of tw samples on a
// cluster of CLUSTER CTAs, each owning H / CLUSTER rows of every hidden layer.

// Bytes of shared memory of a CTA on the cluster route: the slices of the
// hidden layers it owns, the whole last layer, its biases, then X, Ha, Hb
// and R at tw floats a row, then the exchange's mbarriers.
size_t fwd_cluster_smem(int in_pad, int H, int n_layers, int tw) {
  const size_t wts = (size_t)slice_floats(in_pad, H) + (size_t)(n_layers - 1) * slice_floats(H, H) +
                     (size_t)slice_ld(H) * NOUT + cluster_bias_floats(H, n_layers);
  return sizeof(float) * (wts + (size_t)(in_pad + 2 * H + NOUT) * tw + 2 * Exchange::NBAR);
}

// The wide kernel's function on the cluster's partition. Every CTA holds the
// tile's per-sample state (thread tid < tw owns sample tile * tw + tid) and
// computes it alike; CTA 0 writes the trajectory. V: the product variant
// (fused_rk4_wide.cuh, Products), built for H = TILED_H, which the library
// alone launches. H stays an argument: as a constant it made the compiler's
// code for both cluster kernels slower, the adjoint's by 4% at B = 1
// (PERF.md section 6).
template <bool BF16, int V>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NTHREADS, 1)
fused_rk4_fwd_kernel_cluster(const float* __restrict__ y0,    // (B, 6)
                             const float* __restrict__ ts,    // (T, B)
                             const float* __restrict__ meal,  // (T, B)
                             const float* __restrict__ tvns,  // (T, B)
                             const float* __restrict__ ctx,   // (C, B) or null
                             const float* __restrict__ wpack, // weights then biases
                             const float* __restrict__ pvec,  // (32,) PARAM_ORDER
                             const int* __restrict__ cidx,    // (n_cp,) or null
                             float* __restrict__ out,         // (T, 6, B)
                             int B, int T, int C, int in_pad, int H, int n_layers,
                             int substeps, int n_cp, int abs_mode, int tw) {
  extern __shared__ float4 smem4[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int L = n_layers, nmax = split_max(H);
  const int lo = split_lo(H, rank), nl = split_lo(H, rank + 1) - lo;  // this CTA's rows
  using TT = TileOf<V, TILED_NL>;  // tiles of the hidden products
  using TL = TileOf<V, NOUT>;      // of the last layer
  // per layer [nl][slice_ld(K)], K = in_pad, H, ...
  float* Wf = reinterpret_cast<float*>(smem4);
  float* WL = Wf + slice_floats(in_pad, H) + (L - 1) * slice_floats(H, H);  // the last layer, whole
  float* Bs = WL + slice_ld(H) * NOUT;             // biases: [L][nmax] this CTA's rows, the last 8
  float* X = Bs + cluster_bias_floats(H, L);       // [in_pad][tw]
  float* Ha = X + in_pad * tw;                     // [H / 4][tw][4]
  float* Hb = Ha + H * tw;                         // the same
  float* R = Hb + H * tw;                          // [NOUT][tw]
  Exchange ex;                                     // mbarriers of Ha and Hb
  ex.init(reinterpret_cast<unsigned long long*>(R + NOUT * tw));
  auto wf = [&](int l) {
    return Wf + (l == 0 ? 0 : slice_floats(in_pad, H) + (l - 1) * slice_floats(H, H));
  };

  const int tid = threadIdx.x;
  const bool owner = tid < tw;
  const int b = (int)(blockIdx.x / CLUSTER) * tw + tid;
  const bool valid = owner && b < B;
  const bool writer = valid && rank == 0;
  const int L_off = layer_offset(L, in_pad, H);

  for (int l = 0; l < L; ++l)
    load_rows(wf(l), wpack + layer_offset(l, in_pad, H), H, l == 0 ? in_pad : H, lo, nl);
  load_rows(WL, wpack + L_off, NOUT, H, 0, NOUT);
  load_biases(Bs, wpack + L_off + H * NOUT, H, L, lo, nl);
  for (int i = tid; i < in_pad * tw; i += NTHREADS) X[i] = 0.f;
  __syncthreads();

  float P[NP];
  float y[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) y[s] = 0.f;
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
    for (int s = 0; s < NS; ++s) {
      y[s] = y0[b * NS + s];
      if (writer) out[s * B + b] = y[s];
    }
  }
  cluster.sync();  // every CTA's shared memory is live before the first exchange

  const float inv_s = 1.0f / (float)substeps;
  Probes pr;
  pr.start();

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
        pr.lap(PP_STAGE, false);
        if (owner)
          stage_features(c, jf, t, h, inv_s, y, k, m_l, m_r, v_l, v_r, P, X, tw, tid);
        __syncthreads();
        pr.lap(PP_DRIFT, false);
        const float* in = X;
        for (int l = 0; l < L; ++l) {
          float* dst = (l & 1) ? Hb : Ha;
          const float* bias = Bs + l * nmax;
          auto epi = [&](int, int n0, int s0, float (&acc)[TT::RT][TT::CT], int) {
            cl_bias_relu(acc, bias, n0);
            cl_store_ilv(dst, tw, lo + n0, s0, acc);
          };
          if (l)
            cl_dense<BF16, TILED_H, TILED_NL, TT, true>(wf(l), in, tw, NoTag(), epi);
          else if (in_pad == 32)
            cl_dense<BF16, 32, TILED_NL, TT, false>(wf(0), X, tw, NoTag(), epi);
          else
            cl_dense<BF16, 16, TILED_NL, TT, false>(wf(0), X, tw, NoTag(), epi);
          pr.lap(l ? PP_HIDDEN : PP_LAYER0);
          ex.publish(dst + lo * tw, l & 1, 4 * nl * tw);
          ex.wait(l & 1, 4 * (H - nl) * tw);  // the layer's rows are in every CTA; `in` is free
          pr.lap(PP_EXCHANGE, false);
          in = dst;
        }
        cl_dense<BF16, TILED_H, NOUT, TL, true>(
            WL, in, tw, NoTag(), [&](int, int n0, int s0, float (&acc)[TL::RT][TL::CT], int) {
#pragma unroll
              for (int i = 0; i < TL::RT; ++i)
#pragma unroll
                for (int j = 0; j < TL::CT; ++j) acc[i][j] = acc[i][j] + Bs[L * nmax + n0 + i];
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
    if (writer) {
#pragma unroll
      for (int s = 0; s < NS; ++s) out[((i + 1) * NS + s) * B + b] = y[s];
    }
  }
  pr.finish();
  ex.drain();
  cluster.sync();  // no CTA leaves while a peer may still write into it
}

template <bool BF16, int V>
cudaError_t launch_cluster(size_t smem, int clusters, cudaStream_t stream, const float* y0,
                           const float* ts, const float* meal, const float* tvns,
                           const float* ctx, const float* wpack, const float* pvec,
                           const int* cidx, float* out, int B, int T, int C, int in_pad, int H,
                           int n_layers, int substeps, int n_cp, int abs_mode, int tw) {
  auto kernel = fused_rk4_fwd_kernel_cluster<BF16, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<clusters * CLUSTER, NTHREADS, smem, stream>>>(
      y0, ts, meal, tvns, ctx, wpack, pvec, cidx, out, B, T, C, in_pad, H, n_layers, substeps,
      n_cp, abs_mode, tw);
  return cudaGetLastError();
}

}  // namespace

// tile[0] = samples per block: what a caller needs to cross a tile's edge.
extern "C" int fused_rk4_fwd_tile(int* tile) {
  *tile = WTILE;
  return 0;
}

// The cluster route at tile width tw: sizes[0] = CTAs per tile, sizes[1] = 1
// when a product variant runs these widths at tw and a CTA's shared memory
// holds them (else they take the wide route), sizes[2] = its bytes, sizes[3] =
// clusters the card runs at once (0 where the route does not fit), sizes[4] =
// the variant it launches (Products; PRODUCTS_NONE where none runs them).
extern "C" int fused_rk4_fwd_cluster(int in_pad, int H, int n_layers, int tw, long long* sizes) {
  if (tw < 4 || tw > WTILE || tw % 4 != 0 || H < 4 || H % 4 != 0 || in_pad < 4 ||
      in_pad % 4 != 0 || n_layers < 1)
    return (int)cudaErrorInvalidValue;
  const int products = cluster_products(in_pad, H, tw);
  const size_t smem = fwd_cluster_smem(in_pad, H, n_layers, tw);
  sizes[0] = CLUSTER;
  sizes[1] = products != PRODUCTS_NONE && smem <= (size_t)SMEM_LIMIT;
  sizes[2] = (long long)smem;
  sizes[3] = 0;
  sizes[4] = products;
  if (!sizes[1]) return 0;
  int clusters = 0;
  const cudaError_t err =
      products == PRODUCTS_NARROW
          ? max_clusters(fused_rk4_fwd_kernel_cluster<false, PRODUCTS_NARROW>, smem, &clusters)
          : max_clusters(fused_rk4_fwd_kernel_cluster<false, PRODUCTS_WIDE>, smem, &clusters);
  sizes[3] = clusters;
  return (int)err;
}

// tw: 0 for the wide route (64-sample tiles, one block each), else the
// cluster route with tiles of tw samples (a multiple of 4, at most 64), one
// cluster each, where fused_rk4_fwd_cluster says it fits; the caller chooses
// (hybrid_ode_torch/ops/fused_rk4.py). The cluster route's product variant
// follows from the widths (cluster_products).
extern "C" int fused_rk4_fwd(const float* y0, const float* ts, const float* meal,
                             const float* tvns, const float* ctx,
                             const float* wpack, const float* pvec,
                             const int* cidx, float* out, int B, int T, int C,
                             int in_pad, int H, int n_layers, int substeps,
                             int n_cp, int abs_mode, int bf16, int tw, void* stream) {
  const int products = tw ? cluster_products(in_pad, H, tw) : PRODUCTS_NONE;
  if (B < 1 || T < 1 || C < 0 || H < 4 || H % 4 != 0 || in_pad % 4 != 0 ||
      in_pad < NF + (n_cp ? 0 : C) || n_layers < 1 || substeps < 1 ||
      n_cp < 0 || n_cp > NP || (n_cp && n_cp != C) || (C && !ctx) ||
      (n_cp && !cidx) || (long long)T * NS * B > 0x7fffffffLL ||  // int offsets
      tw < 0 || tw > WTILE || tw % 4 != 0 || (tw && products == PRODUCTS_NONE))
    return (int)cudaErrorInvalidValue;
  if (tw) {
    const size_t smem = fwd_cluster_smem(in_pad, H, n_layers, tw);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto go = [&](auto fn) {
      return (int)fn(smem, (B + tw - 1) / tw, (cudaStream_t)stream, y0, ts, meal, tvns, ctx,
                     wpack, pvec, cidx, out, B, T, C, in_pad, H, n_layers, substeps, n_cp,
                     abs_mode, tw);
    };
    if (products == PRODUCTS_NARROW)
      return bf16 ? go(launch_cluster<true, PRODUCTS_NARROW>)
                  : go(launch_cluster<false, PRODUCTS_NARROW>);
    return bf16 ? go(launch_cluster<true, PRODUCTS_WIDE>)
                : go(launch_cluster<false, PRODUCTS_WIDE>);
  }
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
