// Fused Chamfer distance + approximate EMD (approxmatch) for Hopper (sm_90a):
// every pair of two cloud sets, forward only.
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/emd_cd.py::_kernel (launcher
// fused_cd_emd). For each pair (a_s, b_r) of n points each it computes
//   cd   = mean_i min_j d2_ij + mean_j min_i d2_ij   (direct differences)
//   cost = the approxmatch transport cost sum_ij match_ij * sqrt(d2_ij),
// round for round as pdgn_tpu/losses/emd.py::_rounds: nine rounds at
// level_r = -4^(7-r), K_r = exp(level_r * d2), and per round
//   pass 1: ratioL = remainL / (sum_j K remainR + 1e-9)
//   pass 2: sumr = (K^T ratioL) remainR,
//           ratioR = min(remainR / (sumr + 1e-9), 1) remainR,
//           remainR = max(0, remainR - sumr)
//   pass 3: remainL = max(0, remainL - ratioL (K ratioR)),
//           cost += sum_i ratioL_i sum_j K_ij d_ij ratioR_j.
//
// What bounds it on the H100: operations. A pair of 2048-point clouds has
// 4.2M elements; each round touches each of them with an exp and a few
// multiply-adds, against 48 KB of coordinates in and 8 bytes out. The least
// work (a distance once, ~8 FLOP an element a round, three exps an element
// with exponent chaining) is ~5 us a pair at 67 TFLOP/s fp32.
//
// The simple design: the TPU kernel keeps two n x m fp32 matrices (the
// distances and the exp base, 16 MB each at n = 2048) in its VMEM; a Hopper
// block has 227 KB of shared memory. So one block per pair holds only both
// clouds' coordinates (structure of arrays) and the four mass vectors in
// shared memory, and recomputes distances in every sweep:
//   * a row sweep: thread t owns rows t, t+512, ... (4 at a time, one x2
//     load feeding 4 rows) and walks all columns in order, so its row sums
//     are sequential and need no reduction. Exponent chaining, inverted:
//     level_{r-1} = 4 level_r, so K_{r-1} = K_r^4 and round r-1's transport
//     (pass 3) runs inside round r's row sweep at one expf plus two
//     squarings an element;
//   * a column sweep: thread t owns columns t, t+512, ... and walks all rows
//     in order for pass 2's column sums, then updates ratioR and remainR;
//   * the last round's transport is one more row sweep; the Chamfer minima
//     come with round 0's two sweeps.
// Every sum runs in a fixed order (per-thread sequential, then a fixed
// shared-memory tree for the cost and the Chamfer sums): no float atomics,
// and two runs give bit-identical results. expf and sqrtf are the accurate
// ones (no fast-math): at level -16384 many K are denormal and count.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kEmdThreads = 512;
constexpr int kLines = 4;   // rows (or columns) a thread carries per walk
constexpr int kRounds = 9;

struct EmdSmem {
  float* x1;       // (3, n): x | y | z of the left cloud
  float* x2;       // (3, m)
  float* remainL;  // (n)
  float* ratioL;   // (n)
  float* remainR;  // (m)
  float* ratioR;   // (m)
  float* red;      // (kEmdThreads) block reduction scratch
};

// one rounding sequence for every distance, so the row and column sweeps
// see the same d2 (and the same K) for an element
__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

__device__ __forceinline__ float level_of(int r) {
  return -ldexpf(1.f, 2 * (7 - r));  // -4^(7-r), exact
}

// Row sweep. kBalance: pass 1 of the round at `level` (row sums with
// remainR, then ratioL). kTransport: pass 3 of the previous round (its K is
// K^4 when kBalance, else exp(level d2) itself: the final round), which
// updates remainL before pass 1 reads it and adds to `cost`. kChamfer: the
// row minima's sum into `cdrow`.
template <bool kBalance, bool kTransport, bool kChamfer>
__device__ void row_sweep(const EmdSmem& s, int n, int m, float level,
                          float& cost, float& cdrow) {
  for (int i0 = 0; i0 < n; i0 += kEmdThreads * kLines) {
    float ax[kLines], ay[kLines], az[kLines];
    float suml[kLines], tr[kLines], cc[kLines], mn[kLines];
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int i = min(i0 + q * kEmdThreads + (int)threadIdx.x, n - 1);
      ax[q] = s.x1[i];
      ay[q] = s.x1[n + i];
      az[q] = s.x1[2 * n + i];
      suml[q] = 0.f;
      tr[q] = 0.f;
      cc[q] = 0.f;
      mn[q] = INFINITY;
    }
    for (int j = 0; j < m; ++j) {
      const float bx = s.x2[j], by = s.x2[m + j], bz = s.x2[2 * m + j];
      const float rR = kBalance ? s.remainR[j] : 0.f;
      const float qR = kTransport ? s.ratioR[j] : 0.f;
#pragma unroll
      for (int q = 0; q < kLines; ++q) {
        const float d2 = sqdist(ax[q], ay[q], az[q], bx, by, bz);
        if (kChamfer) mn[q] = fminf(mn[q], d2);
        const float k = expf(__fmul_rn(level, d2));
        if (kBalance) suml[q] = __fmaf_rn(k, rR, suml[q]);
        if (kTransport) {
          float kp = k;
          if (kBalance) {
            const float k2 = __fmul_rn(k, k);
            kp = __fmul_rn(k2, k2);
          }
          const float w = __fmul_rn(kp, qR);
          tr[q] = __fadd_rn(tr[q], w);
          cc[q] = __fmaf_rn(w, sqrtf(d2), cc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int i = i0 + q * kEmdThreads + (int)threadIdx.x;
      if (i >= n) continue;
      if (kTransport) {
        const float rl = s.ratioL[i];
        s.remainL[i] = fmaxf(0.f, s.remainL[i] - rl * tr[q]);
        cost = __fmaf_rn(rl, cc[q], cost);
      }
      if (kBalance) s.ratioL[i] = s.remainL[i] / (suml[q] + 1e-9f);
      if (kChamfer) cdrow += mn[q];
    }
  }
}

// Column sweep: pass 2 of the round at `level`; kChamfer adds the column
// minima's sum into `cdcol`.
template <bool kChamfer>
__device__ void col_sweep(const EmdSmem& s, int n, int m, float level,
                          float& cdcol) {
  for (int j0 = 0; j0 < m; j0 += kEmdThreads * kLines) {
    float bx[kLines], by[kLines], bz[kLines], acc[kLines], mn[kLines];
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int j = min(j0 + q * kEmdThreads + (int)threadIdx.x, m - 1);
      bx[q] = s.x2[j];
      by[q] = s.x2[m + j];
      bz[q] = s.x2[2 * m + j];
      acc[q] = 0.f;
      mn[q] = INFINITY;
    }
    for (int i = 0; i < n; ++i) {
      const float ax = s.x1[i], ay = s.x1[n + i], az = s.x1[2 * n + i];
      const float rl = s.ratioL[i];
#pragma unroll
      for (int q = 0; q < kLines; ++q) {
        const float d2 = sqdist(ax, ay, az, bx[q], by[q], bz[q]);
        if (kChamfer) mn[q] = fminf(mn[q], d2);
        const float k = expf(__fmul_rn(level, d2));
        acc[q] = __fmaf_rn(k, rl, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int j = j0 + q * kEmdThreads + (int)threadIdx.x;
      if (j >= m) continue;
      const float rr = s.remainR[j];
      const float sumr = acc[q] * rr;
      const float consumption = fminf(rr / (sumr + 1e-9f), 1.f);
      s.ratioR[j] = consumption * rr;
      s.remainR[j] = fmaxf(0.f, rr - sumr);
      if (kChamfer) cdcol += mn[q];
    }
  }
}

// sum of one value per thread in a fixed tree order
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kEmdThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kEmdThreads, 2)
emd_cd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              int R, int n, int m, float* __restrict__ cd_out,
              float* __restrict__ cost_out) {
  extern __shared__ float smem[];
  EmdSmem s;
  s.x1 = smem;
  s.x2 = s.x1 + 3 * n;
  s.remainL = s.x2 + 3 * m;
  s.ratioL = s.remainL + n;
  s.remainR = s.ratioL + n;
  s.ratioR = s.remainR + m;
  s.red = s.ratioR + m;

  const int pair = blockIdx.x;
  const float* pa = a + (size_t)(pair / R) * n * 3;
  const float* pb = b + (size_t)(pair % R) * m * 3;
  for (int i = threadIdx.x; i < n; i += kEmdThreads) {
    s.x1[i] = pa[3 * i];
    s.x1[n + i] = pa[3 * i + 1];
    s.x1[2 * n + i] = pa[3 * i + 2];
    s.remainL[i] = 1.f;  // multiL = 1: the wrapper takes n == m only
    s.ratioL[i] = 0.f;
  }
  for (int j = threadIdx.x; j < m; j += kEmdThreads) {
    s.x2[j] = pb[3 * j];
    s.x2[m + j] = pb[3 * j + 1];
    s.x2[2 * m + j] = pb[3 * j + 2];
    s.remainR[j] = 1.f;
    s.ratioR[j] = 0.f;
  }
  __syncthreads();

  float cost = 0.f, cdrow = 0.f, cdcol = 0.f;
  row_sweep<true, false, true>(s, n, m, level_of(0), cost, cdrow);
  __syncthreads();
  col_sweep<true>(s, n, m, level_of(0), cdcol);
  __syncthreads();
  for (int r = 1; r < kRounds; ++r) {
    row_sweep<true, true, false>(s, n, m, level_of(r), cost, cdrow);
    __syncthreads();
    col_sweep<false>(s, n, m, level_of(r), cdcol);
    __syncthreads();
  }
  row_sweep<false, true, false>(s, n, m, level_of(kRounds - 1), cost, cdrow);

  const float cost_sum = block_sum(cost, s.red);
  const float row_sum = block_sum(cdrow, s.red);
  const float col_sum = block_sum(cdcol, s.red);
  if (threadIdx.x == 0) {
    cost_out[pair] = cost_sum;
    cd_out[pair] = row_sum / (float)n + col_sum / (float)m;
  }
}

}  // namespace

extern "C" {

// a (S, n, 3), b (R, m, 3) fp32 contiguous -> cd (S, R), cost (S, R): every
// pair (a_s, b_r), one block each. Needs n == m (the approxmatch masses are
// then 1) and (5 (n + m) + 512) floats of shared memory <= 227 KB
// (n <= 5760); a larger request fails in cudaFuncSetAttribute.
int pdgn_emd_cd(const float* a, const float* b, int S, int R, int n, int m,
                float* cd, float* cost, cudaStream_t stream) {
  if (n != m || n < 1 || S < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int smem = (5 * (n + m) + kEmdThreads) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      emd_cd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  emd_cd_kernel<<<S * R, kEmdThreads, smem, stream>>>(a, b, R, n, m, cd,
                                                     cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
