// Edge-conv stage head for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/edge_head.py::_head_kernel
// (launcher _head_pallas): self-kNN with the row minimum dropped, neighbour
// gathers, the window convolution in block channel order, the merge conv's
// fp32 partial, the gated stages' weight-net gather, and the batch-norm sums
// of all of them.
//
// What bounds it on the H100: operations. At stage 4 (N=1024, C=128, 4Fin=1024,
// 2F=512) one cloud costs ~8.1 GFLOP of window conv, ~1.5 GFLOP of merge
// partial and ~0.5 GFLOP of kNN distances against ~40 MB of traffic, so the
// fp32 FMA rate (67 TFLOP/s) is the ceiling.
//
// The simple design: several plain launches instead of one fused body.
//   1. row_sqnorm + knn_kernel: each thread owns one query row and keeps its
//      best k+1 (ascending fp32 norm-expansion distance, lowest index first
//      on ties) in registers by insertion while the sample's rows stream
//      through shared memory in 64-row tiles; slot 0 is dropped. The TPU's
//      packed bf16 keys are not ported: the graph is the fp32-exact one.
//   2. gemm_kernel with a gathered A operand, twice: once for the window conv
//      (A row (n, wp) = [x[idx[n, wp..wp+window-1]] | x[n]], W = [wn; conv_a]),
//      once for the merge partial (A row n = [x[idx[n, :]] | x[n]],
//      W = [wen; a_merge]). Rows are read straight from device memory by index:
//      Hopper has indexed loads, so the TPU's one-hot MXU gathers are gone.
//   3. wnet_kernel: the 32-channel weight-net gather in the generator's
//      (window, j) slot order, plus its sums.
//   4. Batch-norm sums go per block into scratch and column_reduce adds them
//      in a fixed order (deterministic statistics).
#include "common.cuh"

#include <math.h>

namespace {

__global__ void row_sqnorm_kernel(const float* __restrict__ x, int rows, int C,
                                  float* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + (size_t)r * C;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s = fmaf(p[c], p[c], s);
  out[r] = s;
}

constexpr int kTQ = 128;  // query rows per block (one per thread)
constexpr int kTN = 64;   // database rows per shared-memory tile
constexpr int kCK = 32;   // channels per shared-memory chunk

template <int KP1>
__global__ void __launch_bounds__(kTQ)
knn_kernel(const float* __restrict__ x, const float* __restrict__ sq, int N,
           int C, int* __restrict__ idx_out) {
  __shared__ float sQ[kTQ][kCK + 1];
  __shared__ float sD[kTN][kCK + 1];
  __shared__ float sSq[kTN];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int t = threadIdx.x;
  const int q = q0 + t;
  const float* xb = x + (size_t)b * N * C;
  const float* sqb = sq + (size_t)b * N;
  const float qsq = q < N ? sqb[q] : 0.f;

  float bd[KP1];
  int bi[KP1];
#pragma unroll
  for (int s = 0; s < KP1; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  for (int j0 = 0; j0 < N; j0 += kTN) {
    float acc[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kCK) {
      for (int e = t; e < kTQ * kCK; e += kTQ) {
        int r = e / kCK, c = e % kCK;
        int gq = q0 + r, gc = c0 + c;
        sQ[r][c] = (gq < N && gc < C) ? xb[(size_t)gq * C + gc] : 0.f;
      }
      for (int e = t; e < kTN * kCK; e += kTQ) {
        int r = e / kCK, c = e % kCK;
        int gj = j0 + r, gc = c0 + c;
        sD[r][c] = (gj < N && gc < C) ? xb[(size_t)gj * C + gc] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < kCK; ++c) {
        float qv = sQ[t][c];
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[j] = fmaf(qv, sD[j][c], acc[j]);
      }
      __syncthreads();
    }
    if (t < kTN) sSq[t] = (j0 + t < N) ? sqb[j0 + t] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (j0 + j < N) {
        // same rounding order as the plain version: (|q|^2 - 2<q,y>) + |y|^2
        float d = (qsq - 2.f * acc[j]) + sSq[j];
        if (d < bd[KP1 - 1]) {
          bd[KP1 - 1] = d;
          bi[KP1 - 1] = j0 + j;
          // strict < keeps the earlier (lower) index first on ties
#pragma unroll
          for (int s = KP1 - 1; s > 0; --s) {
            if (bd[s] < bd[s - 1]) {
              float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
              int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (q < N) {
    int* o = idx_out + ((size_t)b * N + q) * (KP1 - 1);
#pragma unroll
    for (int s = 1; s < KP1; ++s) o[s - 1] = bi[s];
  }
}

// A row (p, r) with p = b*N + n: slot s < S reads x[b, idx[p, r + s], :],
// the last slot reads x[p, :] itself (the central term rides the product).
struct GatherA {
  const float* x;
  const int* idx;
  int N, C, k, R, S;
  __device__ __forceinline__ float load(int row, int kk) const {
    int s = kk / C, c = kk - s * C;
    int p = row / R, r = row - p * R;
    int src;
    if (s < S) {
      int b = p / N;
      src = b * N + idx[(size_t)p * k + r + s];
    } else {
      src = p;
    }
    return x[(size_t)src * C + c];
  }
};

constexpr int kWRows = 64;  // points per weight-net block

// One thread per (slot s, channel ch) of the 32-channel projection; slot s
// reads extraction index (s % 2) * hk + s / 2, the generator's (window, j)
// order, so the flat outputs line up with the block channel layout.
__global__ void wnet_kernel(const float* __restrict__ pcat,
                            const float* __restrict__ ppoint,
                            const int* __restrict__ idx, int N, int k,
                            int rows, float* __restrict__ wfea,
                            float* __restrict__ wxyz,
                            float* __restrict__ scratch) {
  const int col = threadIdx.x;  // < k * 32
  const int s = col / 32, ch = col % 32;
  const int hk = k / 2;
  const int j = (s % 2) * hk + s / 2;
  const int r0 = blockIdx.x * kWRows;
  const int r1 = min(r0 + kWRows, rows);
  float sum = 0.f, sq = 0.f;
  for (int r = r0; r < r1; ++r) {
    int b = r / N;
    int src = b * N + idx[(size_t)r * k + j];
    float v = pcat[(size_t)src * 32 + ch] + ppoint[(size_t)r * 32 + ch];
    if (ch < 16)
      wfea[(size_t)r * k * 16 + s * 16 + ch] = v;
    else
      wxyz[(size_t)r * k * 16 + s * 16 + ch - 16] = v;
    sum += v;
    sq += v * v;
  }
  float* o = scratch + (size_t)blockIdx.x * 2 * k * 32;
  o[col] = sum;
  o[k * 32 + col] = sq;
}

template <int KP1>
void launch_knn(const float* x, const float* sq, int B, int N, int C, int* idx,
                cudaStream_t stream) {
  dim3 grid((N + kTQ - 1) / kTQ, B);
  knn_kernel<KP1><<<grid, kTQ, 0, stream>>>(x, sq, N, C, idx);
}

}  // namespace

extern "C" {

// x (B,N,C) per-point features; x_knn (B,N,Cf) the features the graph is
// built from; sq (B*N) scratch. w_conv ((window+1)*C, 4Fin) = [wn; conv_a],
// w_merge ((k+1)*C, 2F) = [wen; a_merge]. pcat/ppoint may be null (plain
// stage). conv_scratch holds (rows_conv/64, 2, 4Fin) floats, w_scratch
// (ceil(B*N/64), 2, k*32).
int pdgn_edge_head(const float* x, const float* x_knn, float* sq, int B, int N,
                   int C, int Cf, int k, const float* w_conv,
                   const float* pb_point, int four_fin, const float* w_merge,
                   const float* pb_merge, int two_f, const float* pcat,
                   const float* ppoint, int* idx, float* inte, float* partial,
                   float* stats, float* conv_scratch, float* wfea, float* wxyz,
                   float* wstats, float* w_scratch, cudaStream_t stream) {
  const int rows = B * N;
  const int hk = k / 2;
  const int window = hk + 1;

  row_sqnorm_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(x_knn, rows, Cf,
                                                            sq);
  PDGN_CHECK_LAUNCH();
  switch (k + 1) {
    case 3: launch_knn<3>(x_knn, sq, B, N, Cf, idx, stream); break;
    case 5: launch_knn<5>(x_knn, sq, B, N, Cf, idx, stream); break;
    case 7: launch_knn<7>(x_knn, sq, B, N, Cf, idx, stream); break;
    case 9: launch_knn<9>(x_knn, sq, B, N, Cf, idx, stream); break;
    case 11: launch_knn<11>(x_knn, sq, B, N, Cf, idx, stream); break;
    case 13: launch_knn<13>(x_knn, sq, B, N, Cf, idx, stream); break;
    case 17: launch_knn<17>(x_knn, sq, B, N, Cf, idx, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  PDGN_CHECK_LAUNCH();

  // window conv: rows (b, n, wp), output written straight into inte
  const int rows_conv = rows * hk;
  GatherA a_conv{x, idx, N, C, k, hk, window};
  Epilogue e_conv{inte, pb_point, nullptr, N * hk, four_fin};
  gemm(a_conv, w_conv, rows_conv, (window + 1) * C, four_fin, e_conv,
       conv_scratch, stream);
  PDGN_CHECK_LAUNCH();
  column_reduce(conv_scratch, gemm_row_blocks(rows_conv), 2 * four_fin, stats,
                stream);
  PDGN_CHECK_LAUNCH();

  // merge partial: rows (b, n)
  GatherA a_merge{x, idx, N, C, k, 1, k};
  Epilogue e_merge{partial, pb_merge, nullptr, N, two_f};
  gemm(a_merge, w_merge, rows, (k + 1) * C, two_f, e_merge, nullptr, stream);
  PDGN_CHECK_LAUNCH();

  if (pcat != nullptr) {
    int nblk = (rows + kWRows - 1) / kWRows;
    wnet_kernel<<<nblk, k * 32, 0, stream>>>(pcat, ppoint, idx, N, k, rows,
                                             wfea, wxyz, w_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(w_scratch, nblk, 2 * k * 32, wstats, stream);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

}  // extern "C"
