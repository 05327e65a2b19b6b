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
// and 1.8 MB of outputs; the forward's selection and the backward's test of
// every (center, point) pair add about as much again each.
//
// The design:
//   forward: knn_select (knn.cu, the knn_topk kernel's selection: a warp a
//     center, the sorted list spread over the lanes, a ballot filter and
//     shuffle insertions, the points split between a block's warps when
//     the batch is too small to fill the card) picks the k points by the
//     fp32 direct difference ((dx*dx + dy*dy) + dz*dz) (direct_dist,
//     knn.cuh), each step rounded exactly as the plain version rounds it
//     (no FMA contraction), so both pick the same points, ties to the lower
//     index. Then local_moments_kernel, one thread a center, sums the
//     moments around the center (the shifted form of local_stats.py:18-20:
//     no cancellation) in slot order, and writes the selection's residual,
//     two words a center (the TPU kernel's own): theta, the distance of the
//     k-th point by the same direct_dist, and tie, that point's index. The
//     list is sorted by (distance, index), so the selected set is exactly
//     {j : d_j < theta  or  (d_j == theta and j <= tie)}.
//   backward: no scatter. A block takes 128 source points of one cloud, a
//     thread a point, and streams the cloud's centers through shared memory
//     128 at a time, each staged with its residual and its 15 coefficients
//     (mu, g_mu, G) once. Every thread tests the staged centers 32 at a
//     time, recomputing d = direct_dist(c_t, y_j) (the forward's bits),
//     into a bit mask without a branch, then adds g_mu/k + G (y_j - mu)
//     for the set bits, lowest first: the reverse adjacency's terms in its
//     order (its lists were sorted by center), with no sort, no atomics and
//     no scratch. All threads read the same center at each step, so the
//     loads are shared-memory broadcasts. Selection is rare for a point
//     (about k*M/N centers) but not for a warp: its 32 points need not lie
//     together, and some lane is selected by a large share of the centers,
//     so a branch on each test runs the accumulation for most of them (2.2x
//     slower over a train step's 9 calls on an H100).
#include "common.cuh"
#include "knn.cuh"

#include <math.h>

namespace {

constexpr int kCenters = 128;    // forward: centers a block, one a thread
constexpr int kBwdPoints = 128;  // backward: source points a block
constexpr int kBwdTile = 128;    // backward: centers staged at a time
                                 // (a multiple of 32: one mask word each)

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
                     float* __restrict__ theta_out, int* __restrict__ tie_out,
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
  const int last = ib[K - 1];
  theta_out[(size_t)b * M + t] = pdgn::direct_dist(
      pdgn::load_row4(cp, 3), pdgn::load_row4(sb + (size_t)last * 3, 3));
  tie_out[(size_t)b * M + t] = last;
  mom.write(K, c0, c1, c2, mu_out + ((size_t)b * M + t) * 3,
            cov_out + ((size_t)b * M + t) * 9);
}

// A block takes kBwdPoints source points of cloud blockIdx.y, a thread a
// point: d_src[j] = sum over the centers t that select j, ascending, of
// g_mu_t/K + G_t (y_j - mu_t), the selection rebuilt from (theta, tie)
__global__ void __launch_bounds__(kBwdPoints)
local_stats_bwd_kernel(const float* __restrict__ src,
                       const float* __restrict__ centers,
                       const float* __restrict__ theta,
                       const int* __restrict__ tie,
                       const float* __restrict__ mu,
                       const float* __restrict__ g_mu,
                       const float* __restrict__ g_cov, int N, int M, int K,
                       float* __restrict__ d_src) {
  __shared__ float4 sKey[kBwdTile];       // center xyz, theta
  __shared__ int4 sTie[kBwdTile / 4];
  __shared__ float4 sCoef[kBwdTile][4];   // mu, g_mu, G row-major, 0
  const int b = blockIdx.y;
  const int j = blockIdx.x * kBwdPoints + threadIdx.x;
  const bool live = j < N;
  const float4 y = live ? pdgn::load_row4(src + ((size_t)b * N + j) * 3, 3)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv = 1.f / (float)K;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int t0 = 0; t0 < M; t0 += kBwdTile) {
    __syncthreads();
    for (int s = threadIdx.x; s < kBwdTile; s += kBwdPoints) {
      int* ties = reinterpret_cast<int*>(sTie);
      if (t0 + s >= M) {  // past the last center: selects nothing
        sKey[s] = make_float4(0.f, 0.f, 0.f, -1.f);
        ties[s] = -1;
        continue;
      }
      const size_t ct = (size_t)b * M + t0 + s;  // global center b*M + t
      const float* cp = centers + ct * 3;
      sKey[s] = make_float4(cp[0], cp[1], cp[2], theta[ct]);
      ties[s] = tie[ct];
      const float* gc = g_cov + ct * 9;
      float co[16];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        co[i] = mu[ct * 3 + i];
        co[3 + i] = g_mu[ct * 3 + i];
#pragma unroll
        for (int l = 0; l < 3; ++l)
          co[6 + 3 * i + l] = (gc[3 * i + l] + gc[3 * l + i]) * inv;
      }
      co[15] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sCoef[s][q] = make_float4(co[4 * q], co[4 * q + 1], co[4 * q + 2],
                                  co[4 * q + 3]);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kBwdTile / 32; ++w) {
      // the test, branch-free: bit i of m for center t0 + 32 w + i
      unsigned m = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 tq = sTie[8 * w + q];
        const int ti[4] = {tq.x, tq.y, tq.z, tq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 c = sKey[32 * w + 4 * q + r];
          const float d =
              pdgn::direct_dist(make_float4(c.x, c.y, c.z, 0.f), y);
          const bool sel = (d < c.w) | ((d == c.w) & (j <= ti[r]));
          m |= (unsigned)sel << (4 * q + r);
        }
      }
      // the selected centers, ascending: alpha + G y = g_mu/K + G (y - mu)
      while (m) {
        const int s = 32 * w + __ffs(m) - 1;
        m &= m - 1u;
        const float4 c0 = sCoef[s][0], c1 = sCoef[s][1], c2 = sCoef[s][2],
                     c3 = sCoef[s][3];
        const float e0 = y.x - c0.x, e1 = y.y - c0.y, e2 = y.z - c0.z;
        a0 += c0.w * inv + (c1.z * e0 + c1.w * e1 + c2.x * e2);
        a1 += c1.x * inv + (c2.y * e0 + c2.z * e1 + c2.w * e2);
        a2 += c1.y * inv + (c3.x * e0 + c3.y * e1 + c3.z * e2);
      }
    }
  }
  if (!live) return;
  float* out = d_src + ((size_t)b * N + j) * 3;
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

}  // namespace

extern "C" {

// src (B,N,3), centers (B,M,3) -> idx (B,M,k) int32, the residual theta
// (B,M) fp32 and tie (B,M) int32, mu (B,M,3), cov (B,M,9);
// 1 <= k <= min(N, 128).
int pdgn_local_stats_fwd(const float* src, const float* centers, int B, int N,
                         int M, int k, int* idx, float* theta, int* tie,
                         float* mu, float* cov, cudaStream_t stream) {
  cudaError_t err = pdgn::knn_select(centers, src, B, M, N, 3, k, 0,
                                     /*direct=*/true, idx, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kCenters - 1) / kCenters, B);
  local_moments_kernel<<<grid, kCenters, 0, stream>>>(
      src, centers, idx, N, M, k, theta, tie, mu, cov);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

// theta, tie (B,M) and mu (B,M,3) from the forward; g_mu (B,M,3), g_cov
// (B,M,9) the cotangents -> d_src (B,N,3). One launch, no scratch.
int pdgn_local_stats_bwd(const float* src, const float* centers,
                         const float* theta, const int* tie, const float* mu,
                         const float* g_mu, const float* g_cov, int B, int N,
                         int M, int k, float* d_src, cudaStream_t stream) {
  dim3 grid((N + kBwdPoints - 1) / kBwdPoints, B);
  local_stats_bwd_kernel<<<grid, kBwdPoints, 0, stream>>>(
      src, centers, theta, tie, mu, g_mu, g_cov, N, M, k, d_src);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
