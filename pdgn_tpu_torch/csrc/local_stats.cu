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
// The simple design:
//   forward: one thread per center; the block stages its sample's points in
//     shared memory (12 bytes a point: 24 KB at N=2048) and each thread keeps
//     its best k in registers by insertion (a strict < keeps the earlier,
//     lower index first among equal distances). The distance is rounded
//     exactly as the plain version rounds it (no FMA contraction), so both
//     pick the same points. The moments are summed around the center (the
//     shifted form of local_stats.py:18-20: no cancellation), and the k
//     indices are saved for the backward (k ints per center).
//   backward: the scatter is a gather over the reverse adjacency of the saved
//     indices (common.cuh: counting sort, lists in ascending order), so each
//     point adds its centers' terms in a fixed order: deterministic, no float
//     atomics. One thread per source point.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kCenters = 128;  // centers per block (one per thread)

template <int K>
__global__ void __launch_bounds__(kCenters)
local_stats_fwd_kernel(const float* __restrict__ src,
                       const float* __restrict__ centers, int N, int M,
                       int* __restrict__ idx_out, float* __restrict__ mu_out,
                       float* __restrict__ cov_out) {
  extern __shared__ float s_pts[];  // x[N] | y[N] | z[N]
  const int b = blockIdx.y;
  const int t = blockIdx.x * kCenters + threadIdx.x;
  const float* sb = src + (size_t)b * N * 3;
  for (int i = threadIdx.x; i < N; i += kCenters) {
    s_pts[i] = sb[i * 3 + 0];
    s_pts[N + i] = sb[i * 3 + 1];
    s_pts[2 * N + i] = sb[i * 3 + 2];
  }
  __syncthreads();
  if (t >= M) return;

  const float* cp = centers + ((size_t)b * M + t) * 3;
  const float c0 = cp[0], c1 = cp[1], c2 = cp[2];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  for (int j = 0; j < N; ++j) {
    // ((dx*dx + dy*dy) + dz*dz), each step rounded: the plain version's order
    float dx = __fsub_rn(c0, s_pts[j]);
    float dy = __fsub_rn(c1, s_pts[N + j]);
    float dz = __fsub_rn(c2, s_pts[2 * N + j]);
    float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
    if (d < bd[K - 1]) {
      bd[K - 1] = d;
      bi[K - 1] = j;
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (bd[s] < bd[s - 1]) {
          float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
          int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
        }
      }
    }
  }

  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  float q00 = 0.f, q01 = 0.f, q02 = 0.f, q11 = 0.f, q12 = 0.f, q22 = 0.f;
  int* io = idx_out + ((size_t)b * M + t) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int j = bi[s];
    io[s] = j;
    float e0 = s_pts[j] - c0, e1 = s_pts[N + j] - c1, e2 = s_pts[2 * N + j] - c2;
    s0 += e0; s1 += e1; s2 += e2;
    q00 = fmaf(e0, e0, q00); q01 = fmaf(e0, e1, q01); q02 = fmaf(e0, e2, q02);
    q11 = fmaf(e1, e1, q11); q12 = fmaf(e1, e2, q12); q22 = fmaf(e2, e2, q22);
  }
  const float inv = 1.f / (float)K;
  const float m0 = s0 * inv, m1 = s1 * inv, m2 = s2 * inv;  // mu - c
  float* mo = mu_out + ((size_t)b * M + t) * 3;
  mo[0] = c0 + m0;
  mo[1] = c1 + m1;
  mo[2] = c2 + m2;
  float* co = cov_out + ((size_t)b * M + t) * 9;
  const float v00 = q00 * inv - m0 * m0, v01 = q01 * inv - m0 * m1;
  const float v02 = q02 * inv - m0 * m2, v11 = q11 * inv - m1 * m1;
  const float v12 = q12 * inv - m1 * m2, v22 = q22 * inv - m2 * m2;
  co[0] = v00; co[1] = v01; co[2] = v02;
  co[3] = v01; co[4] = v11; co[5] = v12;
  co[6] = v02; co[7] = v12; co[8] = v22;
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

template <int K>
cudaError_t launch_fwd(const float* src, const float* centers, int B, int N,
                       int M, int* idx, float* mu, float* cov,
                       cudaStream_t stream) {
  const int smem = N * 3 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      local_stats_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kCenters - 1) / kCenters, B);
  local_stats_fwd_kernel<K><<<grid, kCenters, smem, stream>>>(
      src, centers, N, M, idx, mu, cov);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src (B,N,3), centers (B,M,3) -> idx (B,M,k) int32, mu (B,M,3), cov (B,M,9).
// N*12 bytes of src must fit one block's shared memory (N <= 19,000).
int pdgn_local_stats_fwd(const float* src, const float* centers, int B, int N,
                         int M, int k, int* idx, float* mu, float* cov,
                         cudaStream_t stream) {
  switch (k) {
    case 8: return (int)launch_fwd<8>(src, centers, B, N, M, idx, mu, cov, stream);
    case 16: return (int)launch_fwd<16>(src, centers, B, N, M, idx, mu, cov, stream);
    case 20: return (int)launch_fwd<20>(src, centers, B, N, M, idx, mu, cov, stream);
    case 32: return (int)launch_fwd<32>(src, centers, B, N, M, idx, mu, cov, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
