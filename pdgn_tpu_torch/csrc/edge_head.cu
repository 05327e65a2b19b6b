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
//      A] packed by the wrapper. P is scratch, (clouds of the chunk * N, ld); the wrapper cuts the
//      batch into chunks of clouds (at most 1 GiB of P) to bound it.
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
#include "common.cuh"
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
                   const float* __restrict__ ppoint, float* __restrict__ inte,
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
  float4* intev = reinterpret_cast<float4*>(inte);
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
      float4 s = acc[0], q = acc[0] * acc[0];
      intev[(size_t)p * HK * U + u] = acc[0];
#pragma unroll
      for (int wp = 1; wp < HK; ++wp) {
        intev[((size_t)p * HK + wp) * U + u] = acc[wp];
        s = s + acc[wp];
        q = q + acc[wp] * acc[wp];
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
        const float v = pcat[(size_t)row[j] * kProj + lane] + pp;
        if (lane < kProj / 2)
          wfea[((size_t)p * K + s) * (kProj / 2) + lane] = v;
        else
          wxyz[((size_t)p * K + s) * (kProj / 2) + lane - kProj / 2] = v;
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
  V* intev = reinterpret_cast<V*>(inte);
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
        intev[((size_t)p * HK + wp) * U + u] = acc;
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
        const float v = pcat[(size_t)srow[j] * kProj + lane] + pp;
        if (lane < kProj / 2)
          wfea[((size_t)p * K + s) * (kProj / 2) + lane] = v;
        else
          wxyz[((size_t)p * K + s) * (kProj / 2) + lane - kProj / 2] = v;
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
                              float* stats_part, float* w_part,
                              cudaStream_t stream) {
  if (k < 2 || k % 2 || k > kRowSlots) return cudaErrorInvalidValue;
  const int ss = 2 * four_fin + (pcat != nullptr ? 2 * k * kProj : 0);
  const int per_warp = ((ss + kRowSlots + 3) & ~3) * 4;
  int warps = kGSmemMax / per_warp;
  if (warps > 8) warps = 8;
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      head_gather_any_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
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
                          const float* pcat, const float* ppoint, float* inte,
                          float* partial, float* wfea, float* wxyz,
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
                         float* w_part, cudaStream_t stream) {
#define PDGN_GATHER_K(KK)                                                   \
  case KK:                                                                  \
    return launch_gather<KK>(grid, P, ld, idx, rows, N, four_fin, two_f,   \
                             pb_point, pb_merge, pcat, ppoint, inte,       \
                             partial, wfea, wxyz, stats_part, w_part,      \
                             stream);
  if (four_fin % 4 || two_f % 4)
    return launch_gather_any<float>(k, grid, P, ld, idx, rows, N, four_fin,
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
  const int hk = k / 2;
  cudaError_t err = pdgn::knn_select(x_knn, x_knn, B, N, N, Cf, k + 1, 1,
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
    err = gather_for_k(k, grid, P, ld, ix, M, N, four_fin, two_f, pbp, pbm,
                       pc, pp, in, pa, wf, wx, sp, wp, stream);
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

}  // extern "C"
