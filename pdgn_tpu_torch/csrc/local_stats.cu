// Local neighbourhood mean and covariance for Hopper (sm_90a), forward and
// backward.
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/local_stats.py::_fwd_kernel
// (launcher _fwd_pallas) and ::_bwd_kernel (launcher _bwd_pallas), the core
// of the shape-preserving loss:
//   forward:  for every center c, its k nearest points of src (the center
//             itself included when it is a point of src; fp32 direct
//             differences; ascending distance, lowest index first on ties),
//             then mu = mean of the k points and the biased covariance;
//   backward: d_src[j] = sum over the centers t that selected j of
//             alpha_t + G_t y_j, G = (g_cov + g_cov^T)/k,
//             alpha = g_mu/k - G mu  (centers get no gradient).
//
// What bounds it on the H100: operations, and not many. At the train step's
// largest call (B=35, M=1024 centers, N=2048 points) the distances are
// 35*1024*2048*8 = 0.59 GFLOP (9 us at 67 TFLOP/s) against 0.4 MB of points
// and 1.8 MB of outputs; the selection's compares add about as much again.
//
// The design:
//   forward: knn_select (knn.cu, the knn_topk kernel's selection: a warp a
//     center, the sorted list spread over the lanes, a ballot filter and
//     shuffle insertions, the points split between a block's warps when
//     the batch is too small to fill the card) picks the k points by the
//     fp32 direct difference ((dx*dx + dy*dy) + dz*dz), each step rounded
//     exactly as the plain version rounds it (no FMA contraction), so both
//     pick the same points, ties to the lower index. Then
//     local_moments_kernel, one thread a center, sums the moments around
//     the center (the shifted form of local_stats.py:18-20: no
//     cancellation) in slot order. The k indices are saved for the
//     backward (k ints per center).
//   backward: the scatter is a gather over the reverse adjacency of the saved
//     indices (common.cuh: counting sort, lists in ascending order), so each
//     point adds its centers' terms in a fixed order: deterministic, no float
//     atomics. One thread per source point.
#include "common.cuh"
#include "knn.cuh"

#include <math.h>

namespace {

constexpr int kCenters = 128;  // centers per block (one per thread)

// The shifted sums of a neighbourhood (offsets e from the center, in slot
// order), then mu and the biased covariance
struct Moments {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  float q00 = 0.f, q01 = 0.f, q02 = 0.f, q11 = 0.f, q12 = 0.f, q22 = 0.f;

  __device__ __forceinline__ void add(float e0, float e1, float e2) {
    s0 += e0; s1 += e1; s2 += e2;
    q00 = fmaf(e0, e0, q00); q01 = fmaf(e0, e1, q01); q02 = fmaf(e0, e2, q02);
    q11 = fmaf(e1, e1, q11); q12 = fmaf(e1, e2, q12); q22 = fmaf(e2, e2, q22);
  }

  __device__ __forceinline__ void write(int K, float c0, float c1, float c2,
                                        float* mo, float* co) const {
    const float inv = 1.f / (float)K;
    const float m0 = s0 * inv, m1 = s1 * inv, m2 = s2 * inv;  // mu - c
    mo[0] = c0 + m0;
    mo[1] = c1 + m1;
    mo[2] = c2 + m2;
    const float v00 = q00 * inv - m0 * m0, v01 = q01 * inv - m0 * m1;
    const float v02 = q02 * inv - m0 * m2, v11 = q11 * inv - m1 * m1;
    const float v12 = q12 * inv - m1 * m2, v22 = q22 * inv - m2 * m2;
    co[0] = v00; co[1] = v01; co[2] = v02;
    co[3] = v01; co[4] = v11; co[5] = v12;
    co[6] = v02; co[7] = v12; co[8] = v22;
  }
};

// the moments of the k points knn_select chose, one thread a center
__global__ void __launch_bounds__(kCenters)
local_moments_kernel(const float* __restrict__ src,
                     const float* __restrict__ centers,
                     const int* __restrict__ idx, int N, int M, int K,
                     float* __restrict__ mu_out,
                     float* __restrict__ cov_out) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kCenters + threadIdx.x;
  if (t >= M) return;
  const float* sb = src + (size_t)b * N * 3;
  const float* cp = centers + ((size_t)b * M + t) * 3;
  const float c0 = cp[0], c1 = cp[1], c2 = cp[2];
  const int* ib = idx + ((size_t)b * M + t) * K;
  Moments mom;
  for (int s = 0; s < K; ++s) {
    const float* y = sb + (size_t)ib[s] * 3;
    mom.add(y[0] - c0, y[1] - c1, y[2] - c2);
  }
  mom.write(K, c0, c1, c2, mu_out + ((size_t)b * M + t) * 3,
            cov_out + ((size_t)b * M + t) * 9);
}

// one thread per source point: d_src[j] = sum over its entries (t, slot) of
// alpha_t + G_t y_j, in the list's (ascending) order
__global__ void local_stats_bwd_kernel(
    const float* __restrict__ src, const float* __restrict__ mu,
    const float* __restrict__ g_mu, const float* __restrict__ g_cov,
    const int* __restrict__ offsets, const int* __restrict__ entries,
    int rows, int K, float* __restrict__ d_src) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= rows) return;
  const float y0 = src[(size_t)q * 3], y1 = src[(size_t)q * 3 + 1],
              y2 = src[(size_t)q * 3 + 2];
  const float inv = 1.f / (float)K;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int p = offsets[q]; p < offsets[q + 1]; ++p) {
    const size_t ct = (size_t)(entries[p] / K);  // global center b*M + t
    const float* gc = g_cov + ct * 9;
    const float* m = mu + ct * 3;
    const float* gm = g_mu + ct * 3;
    float G[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) G[3 * i + j] = (gc[3 * i + j] + gc[3 * j + i]) * inv;
    // alpha + G y = g_mu/K + G (y - mu)
    const float e0 = y0 - m[0], e1 = y1 - m[1], e2 = y2 - m[2];
    a0 += gm[0] * inv + (G[0] * e0 + G[1] * e1 + G[2] * e2);
    a1 += gm[1] * inv + (G[3] * e0 + G[4] * e1 + G[5] * e2);
    a2 += gm[2] * inv + (G[6] * e0 + G[7] * e1 + G[8] * e2);
  }
  d_src[(size_t)q * 3] = a0;
  d_src[(size_t)q * 3 + 1] = a1;
  d_src[(size_t)q * 3 + 2] = a2;
}

}  // namespace

extern "C" {

// src (B,N,3), centers (B,M,3) -> idx (B,M,k) int32, mu (B,M,3), cov (B,M,9);
// 1 <= k <= min(N, 128).
int pdgn_local_stats_fwd(const float* src, const float* centers, int B, int N,
                         int M, int k, int* idx, float* mu, float* cov,
                         cudaStream_t stream) {
  cudaError_t err = pdgn::knn_select(centers, src, B, M, N, 3, k, 0,
                                     /*direct=*/true, idx, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kCenters - 1) / kCenters, B);
  local_moments_kernel<<<grid, kCenters, 0, stream>>>(src, centers, idx, N, M,
                                                      k, mu, cov);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

// idx (B,M,k) from the forward; g_mu (B,M,3), g_cov (B,M,9) the cotangents.
// Scratch: count, cursor (B*N ints), offsets (B*N+1), entries (B*M*k).
int pdgn_local_stats_bwd(const float* src, const int* idx, const float* mu,
                         const float* g_mu, const float* g_cov, int B, int N,
                         int M, int k, int* count, int* cursor, int* offsets,
                         int* entries, float* d_src, cudaStream_t stream) {
  cudaError_t err = reverse_adjacency(idx, B, M, k, N, count, cursor, offsets,
                                      entries, stream);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * N;
  local_stats_bwd_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(
      src, mu, g_mu, g_cov, offsets, entries, rows, k, d_src);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
