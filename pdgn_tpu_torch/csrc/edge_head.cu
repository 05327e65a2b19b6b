// Edge-conv stage head for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/edge_head.py::_head_kernel
// (launcher _head_pallas): self-kNN with the row minimum dropped, the window
// convolution in block channel order, the merge conv's fp32 partial, the
// gated stages' weight-net rows, and the batch-norm sums of all of them:
//   inte[p, wp]  = x[p] conv_a + pb_point + sum_{t<window} x[idx[p, wp+t]] Wn_t
//   partial[p]   = x[p] A + pb_merge + sum_{j<k} x[idx[p, j]] We_j
//   wfea/wxyz[p] = pcat[idx[p, j(s)]] + ppoint[p] in the (window, j) order.
//
// What bounds it on the H100: operations. x[idx] W = (x W)[idx], so the
// least work is one product of every point with every weight block, 7 of
// C x 4Fin and k+1 of C x 2F a point: at stage 4, B=128 (N=1024, C=128,
// 4Fin=1024, 2F=512) 429.5 GFLOP, 2.6 ms at 3xTF32's fp32-accurate 165
// TFLOP/s; then 4.7 GFLOP of gather adds and 34.4 GFLOP of kNN distances at
// 67 TFLOP/s (fp32 SIMT). Gathering first and multiplying the gathered rows
// costs 35 products of C x 4Fin a point for the window alone, 4.4x the work.
//
// The design: the kNN, then two launches a chunk of clouds:
//   1. pdgn::knn_select (knn.cu, the knn_topk kernel's selection): self-kNN
//      of x_knn for k+1 by the fp32 norm expansion, ascending, lowest index
//      first on ties, slot 0 dropped.
//   2. P = x W_all on the tensor cores in 3xTF32, the shared product core
//      (tf32x3_gemm.cuh; tc_gemm_kernel, no fold: the depth is C <= 128),
//      W_all = [Wn_0 | .. | Wn_{window-1} | conv_a | We_0 | .. | We_{k-1} |
//      A] packed by the wrapper. P is scratch, (clouds of the chunk * N,
//      ld); the wrapper cuts the batch into chunks of clouds (at most 1 GiB
//      of P) to bound it.
//   3. head_gather_kernel<k>: a warp a point, float4 columns: the window sums
//      inte[p, wp] = P_conv_a[p] + pb_point + sum_t P_Wn_t[idx[p, wp+t]]
//      (t ascending), partial[p] = P_A[p] + sum_j P_We_j[idx[p, j]] (j
//      ascending) + pb_merge, and the weight-net rows. Batch-norm sums
//      accumulate per warp in shared memory; the warps fold in a fixed
//      order and a persistent grid writes one partial a block, which
//      column_reduce adds in a fixed order: deterministic statistics.
//      Unrolled for k in {2, 4, 6, 8, 10, 12, 16}; head_gather_any_kernel
//      takes any even k (k + 1 <= 128, knn_select's longest list) at run
//      time, the neighbour rows staged per warp in shared memory, with the
//      same sums in the same order, in float4 columns or, when 4Fin or 2F is
//      not a multiple of 4, in scalar ones.
//
// The bf16 instance (pdgn_edge_head_bf16; the TPU kernel with bf16 x, pcat,
// ppoint and weights, edge_head.py:335-413), redesigned for Hopper in the
// TPU kernel's own shape: gather first, never write P. The fp32 design's P
// would be fp32 (131,072 x 12,800 at stage 4, B=128: 6.7 GB) and go through
// HBM twice, written and read back gathered; in bf16 the gathered rows are
// exact and x (33.5 MB) sits in L2, so the gathered products are cheaper
// than P's traffic.
//
// What bounds it: operations. Gathered, a point's products are hk windows
// of depth window*C against 4Fin columns, conv_a's C x 4Fin, and the
// merge's (k+1)*C x 2F: at stage 4, B=128 (k=10, C=128, 4Fin=1024, 2F=512)
// 1.25 TFLOP, 1.27 ms at the bf16 tensor cores' 989 TFLOP/s, against the
// row's least-work bound of 1.531 ms (x[idx] W = (x W)[idx]: the products
// of every point with every weight block once, plus the graph's distances
// and the adds, counted by chip_smoke.py); then the graph (knn_select on
// the fp32 upcast) ahead of it. In practice the loads bound it: with
// 128 x 256 tiles the kernel moves 10.9 GB of weight slabs and 5.4 GB of
// gathered rows from L2 into shared memory at stage 4, B=128.
//
// The design, after the graph (the bf16 upcast, pdgn::knn_select as the
// fp32 instance's):
//   1. head_bf16_kernel, persistent, one block an SM, one work item a
//      (128-row tile, job, 256-column tile): job wp < hk is window wp,
//      inte[:, wp] = [x[idx[:, wp]] | .. | x[idx[:, wp+window-1]] | x]
//      W_conv + pb_point, W_conv = [Wn_0; ..; Wn_{window-1}; conv_a]; job
//      hk is the merge, partial = [x[idx[:, 0]] | .. | x[idx[:, k-1]] | x]
//      W_merge + pb_merge, W_merge = [We_0; ..; We_{k-1}; A]. Items go
//      round-robin, rotated a block a round so that every block takes
//      every job (head_item). The depth runs in slabs of 64 channels of one
//      slot (the wrapper pads C to cp, a multiple of 64, and packs W^T
//      K-major). One producer warp gathers each slab's 128 rows of x from
//      L2 with cp.async into the 128-byte-swizzled layout (8 lanes a row, 4
//      rows an instruction; each lane's cp.async.mbarrier.arrive lands on
//      the slab's barrier when its copies have), and streams the weight
//      slab (256 columns x 64) by TMA: a 4-stage ring of 48 KB with full
//      and empty mbarriers. Two consumer warpgroups take 64 rows each,
//      fence the gathered rows into the async proxy and run wgmma
//      m64n256k16 (bf16 operands, fp32 accumulation, 4 a slab), keeping one
//      slab's products in flight.
//   2. The epilogue of a window: + pb_point, rounded to bf16 at the
//      (streaming) store of inte, and the batch-norm sums of the rounded
//      values: over each warp's 16 rows by shuffles, the 8 warps folded in
//      a fixed order into the block's own partial row, so column_reduce
//      then adds fixed partials in a fixed order (deterministic). The
//      merge's: + pb_merge, partial in fp32, staged through shared memory
//      so that its rows leave in whole lines.
//   3. head_wrow_bf16_kernel (gated): the weight-net rows pcat[idx] +
//      ppoint in the (window, j) slot order, rounded to bf16, and their
//      sums, as the gather pass does for the fp32 instance.
// No (rows, ld) scratch: the bf16 instance allocates no P.
#include "common.cuh"
#include "hopper.cuh"
#include "knn.cuh"
#include "tf32x3_gemm.cuh"

namespace {

// ------------------------------------------------- 3. the gather pass
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// store value group v (4 columns, or 1) at group index i of out; returns
// the values as stored
__device__ __forceinline__ float4 put_v(float* out, size_t i, float4 v) {
  reinterpret_cast<float4*>(out)[i] = v;
  return v;
}
__device__ __forceinline__ float put_v(float* out, size_t i, float v) {
  out[i] = v;
  return v;
}
constexpr int kProj = 32;  // weight-net channels: 16 fea + 16 xyz

// Pointers are offset to the chunk: P (rows, ld), idx (rows, K) with
// in-cloud indices, pb_* (clouds, width), outputs (rows, ...); four_fin,
// two_f and ld are multiples of 4 and every row 16-byte aligned (float4
// columns). Shared memory: per warp [2][four_fin] and, gated, [2][K * 32]
// floats of sums.
template <int K>
__global__ void __launch_bounds__(256)
head_gather_kernel(const float* __restrict__ P, int ld,
                   const int* __restrict__ idx, int rows, int N, int four_fin,
                   int two_f, const float* __restrict__ pb_point,
                   const float* __restrict__ pb_merge,
                   const float* __restrict__ pcat,
                   const float* __restrict__ ppoint,
                   float* __restrict__ inte,
                   float* __restrict__ partial, float* __restrict__ wfea,
                   float* __restrict__ wxyz, float* __restrict__ stats_part,
                   float* __restrict__ w_part) {
  constexpr int HK = K / 2, WIN = HK + 1;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool gated = pcat != nullptr;
  const int sw = 2 * four_fin + (gated ? 2 * K * kProj : 0);  // per warp
  float* st = smem + warp * sw;
  float* wst = st + 2 * four_fin;
  for (int e = threadIdx.x; e < warps * sw; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();

  const int U = four_fin / 4, U2 = two_f / 4, ldv = ld / 4;
  const float4* Pv = reinterpret_cast<const float4*>(P);
  const float4* pbv = reinterpret_cast<const float4*>(pb_point);
  const float4* pbm = reinterpret_cast<const float4*>(pb_merge);
  float4* partv = reinterpret_cast<float4*>(partial);
  float4* ssum = reinterpret_cast<float4*>(st);
  float4* ssq = reinterpret_cast<float4*>(st + four_fin);
  const size_t ca = (size_t)WIN * U;          // conv_a's columns
  const size_t we = (size_t)(WIN + 1) * U;    // We_0's columns
  const size_t am = we + (size_t)K * U2;      // A's columns

  for (int p = blockIdx.x * warps + warp; p < rows;
       p += gridDim.x * warps) {
    const int b = p / N;
    const int mine = lane < K ? idx[(size_t)p * K + lane] : 0;
    int row[K];  // the neighbours' rows in the chunk
#pragma unroll
    for (int j = 0; j < K; ++j)
      row[j] = b * N + __shfl_sync(0xffffffffu, mine, j);
    const size_t self = (size_t)p * ldv;

    for (int u = lane; u < U; u += 32) {
      const float4 point = Pv[self + ca + u] + pbv[(size_t)b * U + u];
      float4 acc[HK];
#pragma unroll
      for (int wp = 0; wp < HK; ++wp) acc[wp] = point;
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int t = 0; t < WIN; ++t)
          if (j - t >= 0 && j - t < HK)
            acc[j - t] = acc[j - t] + Pv[(size_t)row[j] * ldv + t * U + u];
      const float4 a0 = put_v(inte, (size_t)p * HK * U + u, acc[0]);
      float4 s = a0, q = a0 * a0;
#pragma unroll
      for (int wp = 1; wp < HK; ++wp) {
        const float4 a = put_v(inte, ((size_t)p * HK + wp) * U + u, acc[wp]);
        s = s + a;
        q = q + a * a;
      }
      ssum[u] = ssum[u] + s;
      ssq[u] = ssq[u] + q;
    }

    for (int u = lane; u < U2; u += 32) {
      float4 a = Pv[self + am + u];
#pragma unroll
      for (int j = 0; j < K; ++j)
        a = a + Pv[(size_t)row[j] * ldv + we + (size_t)j * U2 + u];
      partv[(size_t)p * U2 + u] = a + pbm[(size_t)b * U2 + u];
    }

    if (gated) {
      // slot s reads neighbour j = (s % 2) * HK + s / 2; channel = lane
      const float pp = ppoint[(size_t)p * kProj + lane];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int j = (s % 2) * HK + s / 2;
        const float v =
            pcat[(size_t)row[j] * kProj + lane] + pp;
        if (lane < kProj / 2)
          store_as(wfea + ((size_t)p * K + s) * (kProj / 2) + lane, v);
        else
          store_as(wxyz + ((size_t)p * K + s) * (kProj / 2) + lane -
                       kProj / 2,
                   v);
        wst[s * kProj + lane] += v;
        wst[K * kProj + s * kProj + lane] += v * v;
      }
    }
  }
  __syncthreads();

  // fold the warps in a fixed order: one partial a block
  float* o = stats_part + (size_t)blockIdx.x * 2 * four_fin;
  for (int e = threadIdx.x; e < 2 * four_fin; e += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += smem[w * sw + e];
    o[e] = v;
  }
  if (gated) {
    float* ow = w_part + (size_t)blockIdx.x * 2 * K * kProj;
    for (int e = threadIdx.x; e < 2 * K * kProj; e += blockDim.x) {
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += smem[w * sw + 2 * four_fin + e];
      ow[e] = v;
    }
  }
}

// Any even K at run time (the gather of head_gather_kernel<K>, the window
// sums t ascending and the merge sums j ascending as there). V = float4
// (four_fin, two_f multiples of 4, float4 columns) or float (any widths).
// Shared memory per warp: [2][four_fin] sums, gated [2][K * 32] more, then
// kRowSlots ints of neighbour rows.
constexpr int kRowSlots = 128;

__device__ __forceinline__ float4 vsq(float4 a) { return a * a; }
__device__ __forceinline__ float vsq(float a) { return a * a; }

template <class V>
__global__ void __launch_bounds__(256)
head_gather_any_kernel(const float* __restrict__ P, int ld,
                       const int* __restrict__ idx, int rows, int N, int K,
                       int four_fin, int two_f,
                       const float* __restrict__ pb_point,
                       const float* __restrict__ pb_merge,
                       const float* __restrict__ pcat,
                       const float* __restrict__ ppoint,
                       float* __restrict__ inte, float* __restrict__ partial,
                       float* __restrict__ wfea, float* __restrict__ wxyz,
                       float* __restrict__ stats_part,
                       float* __restrict__ w_part) {
  constexpr int VW = sizeof(V) / sizeof(float);
  const int HK = K / 2, WIN = HK + 1;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool gated = pcat != nullptr;
  const int ss = 2 * four_fin + (gated ? 2 * K * kProj : 0);  // sums
  const int sw = (ss + kRowSlots + 3) & ~3;                   // per warp
  float* st = smem + warp * sw;
  float* wst = st + 2 * four_fin;
  int* srow = reinterpret_cast<int*>(st + ss);
  for (int e = threadIdx.x; e < warps * sw; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();

  const int U = four_fin / VW, U2 = two_f / VW, ldv = ld / VW;
  const V* Pv = reinterpret_cast<const V*>(P);
  const V* pbv = reinterpret_cast<const V*>(pb_point);
  const V* pbm = reinterpret_cast<const V*>(pb_merge);
  V* partv = reinterpret_cast<V*>(partial);
  V* ssum = reinterpret_cast<V*>(st);
  V* ssq = reinterpret_cast<V*>(st + four_fin);
  const size_t ca = (size_t)WIN * U;
  const size_t we = (size_t)(WIN + 1) * U;
  const size_t am = we + (size_t)K * U2;

  for (int p = blockIdx.x * warps + warp; p < rows;
       p += gridDim.x * warps) {
    const int b = p / N;
    __syncwarp();  // the previous point's rows are read
    for (int j = lane; j < K; j += 32)
      srow[j] = b * N + idx[(size_t)p * K + j];
    __syncwarp();
    const size_t self = (size_t)p * ldv;

    for (int u = lane; u < U; u += 32) {
      const V point = Pv[self + ca + u] + pbv[(size_t)b * U + u];
      V s = point, q = point;
      for (int wp = 0; wp < HK; ++wp) {
        V acc = point;
        for (int t = 0; t < WIN; ++t)
          acc = acc + Pv[(size_t)srow[wp + t] * ldv + t * U + u];
        acc = put_v(inte, ((size_t)p * HK + wp) * U + u, acc);
        if (wp == 0) {
          s = acc;
          q = vsq(acc);
        } else {
          s = s + acc;
          q = q + vsq(acc);
        }
      }
      ssum[u] = ssum[u] + s;
      ssq[u] = ssq[u] + q;
    }

    for (int u = lane; u < U2; u += 32) {
      V a = Pv[self + am + u];
      for (int j = 0; j < K; ++j)
        a = a + Pv[(size_t)srow[j] * ldv + we + (size_t)j * U2 + u];
      partv[(size_t)p * U2 + u] = a + pbm[(size_t)b * U2 + u];
    }

    if (gated) {
      const float pp = ppoint[(size_t)p * kProj + lane];
      for (int s = 0; s < K; ++s) {
        const int j = (s % 2) * HK + s / 2;
        const float v =
            pcat[(size_t)srow[j] * kProj + lane] + pp;
        if (lane < kProj / 2)
          store_as(wfea + ((size_t)p * K + s) * (kProj / 2) + lane, v);
        else
          store_as(wxyz + ((size_t)p * K + s) * (kProj / 2) + lane -
                       kProj / 2,
                   v);
        wst[s * kProj + lane] += v;
        wst[K * kProj + s * kProj + lane] += v * v;
      }
    }
  }
  __syncthreads();

  float* o = stats_part + (size_t)blockIdx.x * 2 * four_fin;
  for (int e = threadIdx.x; e < 2 * four_fin; e += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += smem[w * sw + e];
    o[e] = v;
  }
  if (gated) {
    float* ow = w_part + (size_t)blockIdx.x * 2 * K * kProj;
    for (int e = threadIdx.x; e < 2 * K * kProj; e += blockDim.x) {
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += smem[w * sw + 2 * four_fin + e];
      ow[e] = v;
    }
  }
}

constexpr int kGSmemMax = 200 * 1024;

template <class V>
cudaError_t launch_gather_any(int k, int grid, const float* P, int ld,
                              const int* idx, int rows, int N, int four_fin,
                              int two_f, const float* pb_point,
                              const float* pb_merge, const float* pcat,
                              const float* ppoint, float* inte,
                              float* partial, float* wfea, float* wxyz,
                              float* stats_part,
                              float* w_part, cudaStream_t stream) {
  if (k < 2 || k % 2 || k > kRowSlots) return cudaErrorInvalidValue;
  const int ss = 2 * four_fin + (pcat != nullptr ? 2 * k * kProj : 0);
  const int per_warp = ((ss + kRowSlots + 3) & ~3) * 4;
  int warps = kGSmemMax / per_warp;
  if (warps > 8) warps = 8;
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      head_gather_any_kernel<V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  head_gather_any_kernel<V><<<grid, warps * 32, smem, stream>>>(
      P, ld, idx, rows, N, k, four_fin, two_f, pb_point, pb_merge, pcat,
      ppoint, inte, partial, wfea, wxyz, stats_part, w_part);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_gather(int grid, const float* P, int ld, const int* idx,
                          int rows, int N, int four_fin, int two_f,
                          const float* pb_point, const float* pb_merge,
                          const float* pcat, const float* ppoint,
                          float* inte, float* partial, float* wfea,
                          float* wxyz,
                          float* stats_part, float* w_part,
                          cudaStream_t stream) {
  const int per_warp =
      (2 * four_fin + (pcat != nullptr ? 2 * K * kProj : 0)) * 4;
  int warps = kGSmemMax / per_warp;
  if (warps > 8) warps = 8;
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      head_gather_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  head_gather_kernel<K><<<grid, warps * 32, smem, stream>>>(
      P, ld, idx, rows, N, four_fin, two_f, pb_point, pb_merge, pcat, ppoint,
      inte, partial, wfea, wxyz, stats_part, w_part);
  return cudaGetLastError();
}

cudaError_t gather_for_k(int k, int grid, const float* P, int ld,
                         const int* idx, int rows, int N, int four_fin,
                         int two_f, const float* pb_point,
                         const float* pb_merge, const float* pcat,
                         const float* ppoint, float* inte, float* partial,
                         float* wfea, float* wxyz, float* stats_part,
                         float* w_part,
                         cudaStream_t stream) {
#define PDGN_GATHER_K(KK)                                                   \
  case KK:                                                                  \
    return launch_gather<KK>(grid, P, ld, idx, rows, N, four_fin, two_f,\
                             pb_point, pb_merge, pcat, ppoint, inte,       \
                             partial, wfea, wxyz, stats_part, w_part,      \
                             stream);
  if (four_fin % 4 || two_f % 4)
    return launch_gather_any<float>(k, grid, P, ld, idx, rows, N,
                                       four_fin,
                                    two_f, pb_point, pb_merge, pcat, ppoint,
                                    inte, partial, wfea, wxyz, stats_part,
                                    w_part, stream);
  switch (k) {
    PDGN_GATHER_K(2)
    PDGN_GATHER_K(4)
    PDGN_GATHER_K(6)
    PDGN_GATHER_K(8)
    PDGN_GATHER_K(10)
    PDGN_GATHER_K(12)
    PDGN_GATHER_K(16)
    default:
      return launch_gather_any<float4>(k, grid, P, ld, idx, rows, N,
                                       four_fin, two_f, pb_point, pb_merge,
                                       pcat, ppoint, inte, partial, wfea,
                                       wxyz, stats_part, w_part, stream);
  }
#undef PDGN_GATHER_K
}

// 1. and 2.-3. of the fp32 instance; xk the graph's input
int edge_head_impl(const float* x, const float* xk, int B, int N, int C,
                   int Cf, int k, const float* w_all, int ld, int four_fin,
                   int two_f, const float* pb_point, const float* pb_merge,
                   const float* pcat, const float* ppoint, int* idx,
                   float* inte, float* partial, float* stats, float* wfea,
                   float* wxyz, float* wstats, float* P, int chunk, int grid,
                   float* stats_part, float* w_part, cudaStream_t stream) {
  const int hk = k / 2;
  cudaError_t err = pdgn::knn_select(xk, xk, B, N, N, Cf, k + 1, 1,
                                     /*direct=*/false, idx, nullptr, stream);
  if (err != cudaSuccess) return (int)err;

  const bool gated = pcat != nullptr;
  int nchunks = 0;
  for (int b0 = 0; b0 < B; b0 += chunk, ++nchunks) {
    const int nc = B - b0 < chunk ? B - b0 : chunk;
    const int M = nc * N;
    const size_t r0 = (size_t)b0 * N;
    err = tc_gemm<false, 0>(RowsA{x + r0 * C, C}, w_all, ld, M, ld, C, C,
                            StorePairs{P, ld}, stream);
    if (err != cudaSuccess) return (int)err;
    float* sp = stats_part + (size_t)nchunks * grid * 2 * four_fin;
    float* wp = gated ? w_part + (size_t)nchunks * grid * 2 * k * kProj
                      : nullptr;
    const float* pc = gated ? pcat + r0 * kProj : nullptr;
    const float* pp = gated ? ppoint + r0 * kProj : nullptr;
    float* wf = gated ? wfea + r0 * k * (kProj / 2) : nullptr;
    float* wx = gated ? wxyz + r0 * k * (kProj / 2) : nullptr;
    const int* ix = idx + r0 * k;
    float* in = inte + r0 * hk * four_fin;
    float* pa = partial + r0 * two_f;
    const float* pbp = pb_point + (size_t)b0 * four_fin;
    const float* pbm = pb_merge + (size_t)b0 * two_f;
    err = gather_for_k(k, grid, P, ld, ix, M, N, four_fin, two_f, pbp,
                          pbm, pc, pp, in, pa, wf, wx, sp, wp, stream);
    if (err != cudaSuccess) return (int)err;
  }
  column_reduce(stats_part, nchunks * grid, 2 * four_fin, stats, stream);
  PDGN_CHECK_LAUNCH();
  if (gated) {
    column_reduce(w_part, nchunks * grid, 2 * k * kProj, wstats, stream);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

__global__ void bf16_to_f32_kernel(const __nv_bfloat16* __restrict__ in,
                                   long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __bfloat162float(in[i]);
}

// ------------------------------------ the bf16 instance: gather first
constexpr int kHM = 128;          // query rows a tile: two warpgroups of 64
constexpr int kHN = 256;          // columns a tile: one m64n256k16 a group
constexpr int kHK = 64;           // depth a slab: 64 channels of one slot
constexpr int kHStages = 4;
constexpr int kHConsumers = 256;  // two warpgroups
constexpr int kHThreads = kHConsumers + 32;  // and the producer warp
constexpr int kHABytes = kHM * kHK * 2;      // 16 KB a stage
constexpr int kHBBytes = kHN * kHK * 2;      // 32 KB a stage
// the ring (1024-aligned), its barriers, the warps' sums [8][2][kHN] (the
// merge's staging of partial, [128][32] floats, in the same 16 KB)
constexpr int kHSmemBytes = 1024 + kHStages * (kHABytes + kHBBytes) +
                            2 * kHStages * 8 + 8 * 2 * kHN * 4;
static_assert(8 * 2 * kHN >= kHM * 32, "the merge's staging");

struct HeadBf16Args {
  const __nv_bfloat16* x;  // (rows, cp), cp a multiple of 64
  const int* idx;          // (rows, k), in-cloud indices
  const float* pb_point;   // (B, four_fin)
  const float* pb_merge;   // (B, two_f)
  __nv_bfloat16* inte;     // (rows, hk * four_fin)
  float* partial;          // (rows, two_f)
  float* stats_part;       // (gridDim.x, 2, four_fin)
  int rows, N, cp, k, four_fin, two_f;
  int ct_conv, ct_merge;   // column tiles of a window, of the merge
  int items;               // row tiles * (hk * ct_conv + ct_merge)
};

// a work item: row tile, job (window wp < hk, or hk: the merge), column tile
struct HeadItem {
  int rt, job, ct;
};

// Item i of the round-robin over the persistent grid. Round j holds items
// j G .. j G + G - 1 (G = gridDim.x), and block b takes item j G + (b + j)
// % G of a whole round: with G a multiple of a row tile's item count (132 =
// 6 * 22 at stage 4), plain round-robin gives each block one job for good,
// and the merge's blocks 22 slabs an item against the windows' 14.
__device__ __forceinline__ HeadItem head_item(const HeadBf16Args& a, int i) {
  const int G = gridDim.x, j = i / G, base = j * G;
  if (base + G <= a.items) i = base + (i - base + j) % G;
  const int hk = a.k / 2, per = hk * a.ct_conv + a.ct_merge;
  HeadItem w;
  w.rt = i / per;
  const int r = i - w.rt * per;
  if (r < hk * a.ct_conv) {
    w.job = r / a.ct_conv;
    w.ct = r - w.job * a.ct_conv;
  } else {
    w.job = hk;
    w.ct = r - hk * a.ct_conv;
  }
  return w;
}

// slots of a job's depth: a window's window neighbours, or the merge's k,
// then the point itself
__device__ __forceinline__ int head_slots(const HeadBf16Args& a, int job) {
  return job < a.k / 2 ? a.k / 2 + 2 : a.k + 1;
}

__global__ void __launch_bounds__(kHThreads, 1)
head_bf16_kernel(const __grid_constant__ CUtensorMap map_conv,
                 const __grid_constant__ CUtensorMap map_merge,
                 const HeadBf16Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Bs = As + kHStages * kHABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kHStages * kHBBytes);
  const Ring ring{full, full + kHStages, kHStages};
  float* wsum = reinterpret_cast<float*>(full + 2 * kHStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = a.k / 2, chunks = a.cp / kHK;
  if (threadIdx.x == 0) {
    // full: the producer's lanes, and its TMA; empty: the consumer warps
    ring.init(32 + 1, kHConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kHConsumers / 32) {
    // the producer: lane l reads the source rows of tile rows l + 32 q; a
    // cp.async instruction copies 4 tile rows, 8 lanes a 128-byte row;
    // each lane arrives on the slab's barrier once its copies have landed
    int it = 0;  // ring position of the next slab
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      const HeadItem w = head_item(a, item);
      const CUtensorMap* map = w.job < hk ? &map_conv : &map_merge;
      const int slots = head_slots(a, w.job);
      for (int slot = 0; slot < slots; ++slot) {
        int src[4];  // the rows this slot reads, -1 past the last row
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = w.rt * kHM + lane + 32 * q;
          if (p >= a.rows)
            src[q] = -1;
          else if (slot == slots - 1)
            src[q] = p;
          else
            src[q] = p / a.N * a.N +
                     a.idx[(size_t)p * a.k + (w.job < hk ? w.job : 0) + slot];
        }
        for (int ch = 0; ch < chunks; ++ch, ++it) {
          const int st = ring.stage(it);
          ring.wait_empty(it);
          __syncwarp();
          if (lane == 0) {
            mbar_arrive_tx(ring.full_bar(it), kHBBytes);
            tma_load_2d(Bs + st * kHBBytes, map, ring.full_bar(it),
                        (slot * chunks + ch) * kHK, w.ct * kHN);
          }
          uint8_t* as = As + st * kHABytes;
          const int c = lane & 7;
#pragma unroll
          for (int j = 0; j < kHM / 4; ++j) {
            const int r = 4 * j + (lane >> 3);  // held by lane r % 32
            const int row = __shfl_sync(0xffffffffu, src[j / 8], r & 31);
            cp_async16(as + r * 128 + ((c ^ swizzle_row(r)) << 4),
                       a.x + (size_t)(row < 0 ? 0 : row) * a.cp + ch * kHK +
                           8 * c,
                       row < 0 ? 0 : 16);
          }
          cp_async_arrive_noinc(ring.full_bar(it));
        }
      }
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup wg takes tile rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  float* sp = a.stats_part + (size_t)blockIdx.x * 2 * a.four_fin;
  for (int e = threadIdx.x; e < 2 * a.four_fin; e += kHConsumers) sp[e] = 0.f;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const HeadItem w = head_item(a, item);
    const int nslab = head_slots(a, w.job) * chunks;
    for (int s = 0; s < nslab; ++s, ++it) {
      const int st = ring.stage(it);
      ring.wait_full(it);
      __syncwarp();
      fence_proxy_async();  // the gathered rows, written by cp.async
      const uint64_t da =
          sw128_desc(As + st * kHABytes + wg * (kHABytes / 2));
      const uint64_t db = sw128_desc(Bs + st * kHBBytes);
      wgmma_slab<kHK / 16>(acc, da, db, s > 0);
      wgmma_wait<1>();  // the previous slab's products are done: free it
      if (s > 0 && lane == 0) ring.release(it - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) ring.release(it - 1);

    // rows row0 and row0 + 8 of columns c0 + 8 i (+ 1)
    const int row0 = w.rt * kHM + wg * 64 + (warp & 3) * 16 + g;
    const int c0 = w.ct * kHN + 2 * t;
    const bool ok0 = row0 < a.rows, ok1 = row0 + 8 < a.rows;
    const int b0 = ok0 ? row0 / a.N : 0, b1 = ok1 ? (row0 + 8) / a.N : 0;
    if (w.job < hk) {
      const float* pb0 = a.pb_point + (size_t)b0 * a.four_fin;
      const float* pb1 = a.pb_point + (size_t)b1 * a.four_fin;
      __nv_bfloat16* o0 = a.inte + ((size_t)row0 * hk + w.job) * a.four_fin;
      __nv_bfloat16* o1 = o0 + (size_t)8 * hk * a.four_fin;
      const bool pairs = (a.four_fin & 1) == 0;
      float* ws = wsum + warp * 2 * kHN;
#pragma unroll
      for (int i = 0; i < kHN / 8; ++i) {
        const int c = c0 + 8 * i;
        const bool in0 = c < a.four_fin, in1 = c + 1 < a.four_fin;
        // inte as stored (rounded to bf16), 0 outside the output
        const float v0 =
            ok0 && in0 ? round_as<__nv_bfloat16>(acc[4 * i] + pb0[c]) : 0.f;
        const float v1 =
            ok0 && in1 ? round_as<__nv_bfloat16>(acc[4 * i + 1] + pb0[c + 1])
                       : 0.f;
        const float v2 =
            ok1 && in0 ? round_as<__nv_bfloat16>(acc[4 * i + 2] + pb1[c])
                       : 0.f;
        const float v3 =
            ok1 && in1 ? round_as<__nv_bfloat16>(acc[4 * i + 3] + pb1[c + 1])
                       : 0.f;
        if (pairs && in1) {  // streaming stores: inte is read much later
          if (ok0)
            __stcs(reinterpret_cast<__nv_bfloat162*>(o0 + c),
                   __floats2bfloat162_rn(v0, v1));
          if (ok1)
            __stcs(reinterpret_cast<__nv_bfloat162*>(o1 + c),
                   __floats2bfloat162_rn(v2, v3));
        } else {
          if (ok0 && in0) store_as(o0 + c, v0);
          if (ok0 && in1) store_as(o0 + c + 1, v1);
          if (ok1 && in0) store_as(o1 + c, v2);
          if (ok1 && in1) store_as(o1 + c + 1, v3);
        }
        float s0 = v0 + v2, s1 = v1 + v3;
        float q0 = v0 * v0 + v2 * v2, q1 = v1 * v1 + v3 * v3;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // over g: the warp's rows
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          q0 += __shfl_xor_sync(0xffffffffu, q0, off);
          q1 += __shfl_xor_sync(0xffffffffu, q1, off);
        }
        if (g == 0) {
          ws[8 * i + 2 * t] = s0;
          ws[8 * i + 2 * t + 1] = s1;
          ws[kHN + 8 * i + 2 * t] = q0;
          ws[kHN + 8 * i + 2 * t + 1] = q1;
        }
      }
      bar_sync(1, kHConsumers);
      // the 8 warps in a fixed order into this block's partial
      for (int e = threadIdx.x; e < 2 * kHN; e += kHConsumers) {
        const int col = w.ct * kHN + e % kHN;
        if (col < a.four_fin) {
          float v = 0.f;
          for (int ww = 0; ww < kHConsumers / 32; ++ww)
            v += wsum[ww * 2 * kHN + e];
          sp[(e / kHN) * a.four_fin + col] += v;
        }
      }
      bar_sync(1, kHConsumers);  // the warps' sums are read
    } else {
      // partial goes out through shared memory (the warps' sums' 16 KB), 32
      // columns at a time, each row in whole 128-byte lines: stored from
      // the fragments, the 8 rows of an instruction lie 2F * 4 bytes apart
      // (2 KB at stage 4)
      const float* pm0 = a.pb_merge + (size_t)b0 * a.two_f;
      const float* pm1 = a.pb_merge + (size_t)b1 * a.two_f;
      float* stg = wsum;  // [128][32], granule q of row r at q ^ (r % 8)
      const int rl = wg * 64 + (warp & 3) * 16 + g;  // tile rows rl, rl + 8
      const bool quads = (a.two_f & 3) == 0;
#pragma unroll
      for (int m = 0; m < kHN / 32; ++m) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = 4 * m + ii;
          const int c = c0 + 8 * i;
          const bool in0 = c < a.two_f, in1 = c + 1 < a.two_f;
          const int at =
              (((2 * ii + (t >> 1)) ^ swizzle_row(rl)) << 2) + 2 * (t & 1);
          *reinterpret_cast<float2*>(stg + rl * 32 + at) =
              make_float2(in0 ? acc[4 * i] + pm0[c] : 0.f,
                          in1 ? acc[4 * i + 1] + pm0[c + 1] : 0.f);
          *reinterpret_cast<float2*>(stg + (rl + 8) * 32 + at) =
              make_float2(in0 ? acc[4 * i + 2] + pm1[c] : 0.f,
                          in1 ? acc[4 * i + 3] + pm1[c + 1] : 0.f);
        }
        bar_sync(1, kHConsumers);
        for (int e = threadIdx.x; e < kHM * 8; e += kHConsumers) {
          const int r = e >> 3, q = e & 7;
          const int row = w.rt * kHM + r;
          const int col = w.ct * kHN + 32 * m + 4 * q;
          if (row < a.rows && col < a.two_f) {
            const float4 v = *reinterpret_cast<const float4*>(
                stg + r * 32 + ((q ^ swizzle_row(r)) << 2));
            float* o = a.partial + (size_t)row * a.two_f + col;
            if (quads) {
              *reinterpret_cast<float4*>(o) = v;
            } else {
              o[0] = v.x;
              if (col + 1 < a.two_f) o[1] = v.y;
              if (col + 2 < a.two_f) o[2] = v.z;
              if (col + 3 < a.two_f) o[3] = v.w;
            }
          }
        }
        bar_sync(1, kHConsumers);  // the chunk is read
      }
    }
  }
}

// The bf16 instance's weight-net rows: a warp a point, lane = channel;
// slot s reads neighbour j = (s % 2) * hk + s / 2; the rows rounded to
// bf16 and their sums (of the rounded values) per warp in shared memory
// ([2][K * 32] floats a warp), the warps folded in a fixed order into one
// partial a block. The gated part of head_gather_any_kernel.
__global__ void __launch_bounds__(256)
head_wrow_bf16_kernel(const int* __restrict__ idx, int rows, int N, int K,
                      const __nv_bfloat16* __restrict__ pcat,
                      const __nv_bfloat16* __restrict__ ppoint,
                      __nv_bfloat16* __restrict__ wfea,
                      __nv_bfloat16* __restrict__ wxyz,
                      float* __restrict__ w_part) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HK = K / 2, sw = 2 * K * kProj;
  float* wst = smem + warp * sw;
  for (int e = threadIdx.x; e < warps * sw; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();
  for (int p = blockIdx.x * warps + warp; p < rows;
       p += gridDim.x * warps) {
    const int b = p / N;
    const float pp = to_f32(ppoint[(size_t)p * kProj + lane]);
    for (int s = 0; s < K; ++s) {
      const int j = (s % 2) * HK + s / 2;
      const int row = b * N + idx[(size_t)p * K + j];
      const float v = round_as<__nv_bfloat16>(
          to_f32(pcat[(size_t)row * kProj + lane]) + pp);
      if (lane < kProj / 2)
        store_as(wfea + ((size_t)p * K + s) * (kProj / 2) + lane, v);
      else
        store_as(wxyz + ((size_t)p * K + s) * (kProj / 2) + lane -
                     kProj / 2,
                 v);
      wst[s * kProj + lane] += v;
      wst[K * kProj + s * kProj + lane] += v * v;
    }
  }
  __syncthreads();
  float* ow = w_part + (size_t)blockIdx.x * sw;
  for (int e = threadIdx.x; e < sw; e += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += smem[w * sw + e];
    ow[e] = v;
  }
}

}  // namespace

extern "C" {

// x (B, N, C) per-point features, C % 4 == 0 (the wrapper pads), 16-byte
// aligned; x_knn (B, N, Cf) the features the graph is built from; even k,
// k + 1 <= 128. w_all (C, ld) = [Wn_0 | .. | Wn_{window-1} | conv_a | We_0 |
// .. | We_{k-1} | A], zero-padded to ld % 4 == 0 columns; pb_* 16-byte
// aligned when four_fin and two_f are multiples of 4 (float4 columns; other
// widths take scalar ones). pcat/ppoint null: plain stage. Clouds go in
// chunks of `chunk`: P holds (chunk * N, ld) floats, stats_part
// (ceil(B / chunk) * grid, 2, four_fin), w_part (.., 2, k*32).
int pdgn_edge_head(const float* x, const float* x_knn, int B, int N, int C,
                   int Cf, int k, const float* w_all, int ld, int four_fin,
                   int two_f, const float* pb_point,
                   const float* pb_merge, const float* pcat,
                   const float* ppoint, int* idx, float* inte,
                   float* partial, float* stats, float* wfea, float* wxyz,
                   float* wstats, float* P, int chunk, int grid,
                   float* stats_part, float* w_part, cudaStream_t stream) {
  if (C % 4 || ld % 4 || k < 2 || k % 2 || chunk < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  return edge_head_impl(
      x, x_knn, B, N, C, Cf, k, w_all, ld, four_fin, two_f, pb_point,
      pb_merge, pcat, ppoint, idx, inte, partial, stats, wfea, wxyz, wstats,
      P, chunk, grid, stats_part, w_part, stream);
}

// The bf16 instance: x (B, N, cp) bf16, C zero-padded to cp, a multiple
// of 64, 16-byte aligned; x_knn (B, N, Cf) bf16; even k, k + 1 <= 128;
// w_conv (four_fin, (window + 1) * cp) = [Wn_0 | .. | Wn_{window-1} |
// conv_a]^T and w_merge (two_f, (k + 1) * cp) = [We_0 | .. | We_{k-1} |
// A]^T, bf16, each slot's block zero-padded to cp; pb_* fp32; pcat, ppoint,
// inte, wfea and wxyz bf16; partial and the sums fp32; grid blocks (one an
// SM): stats_part (grid, 2, four_fin) and w_part (grid, 2, k*32) floats;
// xk scratch (B, N, Cf) floats for the graph's input.
int pdgn_edge_head_bf16(const __nv_bfloat16* x, const __nv_bfloat16* x_knn,
                        int B, int N, int cp, int Cf, int k,
                        const __nv_bfloat16* w_conv,
                        const __nv_bfloat16* w_merge, int four_fin,
                        int two_f, const float* pb_point,
                        const float* pb_merge, const __nv_bfloat16* pcat,
                        const __nv_bfloat16* ppoint, int* idx,
                        __nv_bfloat16* inte, float* partial, float* stats,
                        __nv_bfloat16* wfea, __nv_bfloat16* wxyz,
                        float* wstats, int grid, float* stats_part,
                        float* w_part, float* xk, cudaStream_t stream) {
  const long long rows = (long long)B * N;
  const int hk = k / 2, window = hk + 1;
  if (cp < kHK || cp % kHK || k < 2 || k % 2 || k + 1 > kRowSlots ||
      grid < 1 || four_fin < 1 || two_f < 1 || rows < 1 ||
      rows * k >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  HeadBf16Args a{x, idx, pb_point, pb_merge, inte, partial, stats_part,
                 (int)rows, N, cp, k, four_fin, two_f,
                 (four_fin + kHN - 1) / kHN, (two_f + kHN - 1) / kHN, 0};

  const long long n = rows * Cf;
  bf16_to_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      x_knn, n, xk);
  PDGN_CHECK_LAUNCH();
  cudaError_t err = pdgn::knn_select(xk, xk, B, N, N, Cf, k + 1, 1,
                                     /*direct=*/false, idx, nullptr, stream);
  if (err != cudaSuccess) return (int)err;

  const long long items =
      (rows + kHM - 1) / kHM * (hk * a.ct_conv + a.ct_merge);
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  CUtensorMap map_conv, map_merge;
  err = bf16_tile_map(&map_conv, w_conv, four_fin, (long long)(window + 1) * cp,
                      (long long)(window + 1) * cp, kHN);
  if (err != cudaSuccess) return (int)err;
  err = bf16_tile_map(&map_merge, w_merge, two_f, (long long)(k + 1) * cp,
                      (long long)(k + 1) * cp, kHN);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(head_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHSmemBytes);
  if (err != cudaSuccess) return (int)err;
  head_bf16_kernel<<<grid, kHThreads, kHSmemBytes, stream>>>(map_conv,
                                                            map_merge, a);
  PDGN_CHECK_LAUNCH();
  column_reduce(stats_part, grid, 2 * four_fin, stats, stream);
  PDGN_CHECK_LAUNCH();
  if (pcat == nullptr) return (int)cudaSuccess;

  const int per_warp = 2 * k * kProj * 4;
  int warps = kGSmemMax / per_warp;
  if (warps > 8) warps = 8;
  err = cudaFuncSetAttribute(head_wrow_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             warps * per_warp);
  if (err != cudaSuccess) return (int)err;
  head_wrow_bf16_kernel<<<grid, warps * 32, warps * per_warp, stream>>>(
      idx, (int)rows, N, k, pcat, ppoint, wfea, wxyz, w_part);
  PDGN_CHECK_LAUNCH();
  column_reduce(w_part, grid, 2 * k * kProj, wstats, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
