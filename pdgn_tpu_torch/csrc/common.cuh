// Shared device code of the port's kernels: the LeakyReLU of the generator,
// a deterministic cross-block column reduction and a simple tiled fp32 GEMM
// whose A operand comes through a loader (plain rows or gathered rows).
//
// Everything sits in an anonymous namespace: each .cu file compiles its own
// copy, so the objects link into one library without clashing symbols.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : 0.01f * v;
}

// out[c] = sum over b (ascending) of in[b * ncol + c]. Per-block partial
// sums land in scratch first and this pass adds them in a fixed order, so
// batch statistics do not move from run to run. fp64 accumulation keeps the
// sum of many block partials at fp32 accuracy.
__global__ void column_reduce_kernel(const float* __restrict__ in, int nblk,
                                     int ncol, float* __restrict__ out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  double acc = 0.0;
  for (int b = 0; b < nblk; ++b) acc += (double)in[(size_t)b * ncol + c];
  out[c] = (float)acc;
}

inline void column_reduce(const float* in, int nblk, int ncol, float* out,
                          cudaStream_t stream) {
  int threads = 256;
  column_reduce_kernel<<<(ncol + threads - 1) / threads, threads, 0, stream>>>(
      in, nblk, ncol, out);
}

// ------------------------------------------------------------------ GEMM
// C[M, Nout] = A[M, K] @ W[K, Nout], 64x64 output tile per block, depth 16
// per step, 256 threads each holding a 4x4 strided micro-tile in registers.
// fp32 FMA throughout (no tensor cores): the port's first kernels are
// plain and exact; a later PR moves them to wgmma.
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

struct PlainA {
  const float* a;  // (M, K) row-major
  int K;
  __device__ __forceinline__ float load(int row, int kk) const {
    return a[(size_t)row * K + kk];
  }
};

// out = (addend + acc) + bias[row / bias_div]; bias_div == 0 -> one bias row.
struct Epilogue {
  float* out;
  const float* bias;
  const float* addend;  // nullable (M, Nout)
  int bias_div;
  int Nout;
  __device__ __forceinline__ float operator()(int row, int col,
                                              float acc) const {
    size_t o = (size_t)row * Nout + col;
    float v = addend ? addend[o] + acc : acc;
    v += bias[(size_t)(bias_div ? row / bias_div : 0) * Nout + col];
    out[o] = v;
    return v;
  }
};

// stats (nullable): per row-block column sums and sums of squares of the
// stored output, laid out (gridDim.y, 2, Nout) for column_reduce.
template <class ALoad>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(ALoad A, const float* __restrict__ W, int M, int K, int Nout,
            Epilogue epi, float* __restrict__ stats) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  __shared__ float red[2][16][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int e = tid + q * kThreads;
      int r = e / kBK, kk = e % kBK;
      int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? A.load(gr, gk) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int e = tid + q * kThreads;
      int kk = e / kBN, c = e % kBN;
      int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < Nout) ? W[(size_t)gk * Nout + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  float cq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = col0 + tx + 16 * j;
      if (gc >= Nout) continue;
      float v = epi(gr, gc, acc[i][j]);
      cs[j] += v;
      cq[j] += v * v;
    }
  }
  if (stats != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx + 16 * j] = cs[j];
      red[1][ty][tx + 16 * j] = cq[j];
    }
    __syncthreads();
    if (tid < 2 * kBN) {
      int which = tid / kBN, c = tid % kBN;
      int gc = col0 + c;
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += red[which][t][c];
      if (gc < Nout) stats[((size_t)blockIdx.y * 2 + which) * Nout + gc] = s;
    }
  }
}

template <class ALoad>
inline void gemm(ALoad A, const float* W, int M, int K, int Nout, Epilogue epi,
                 float* stats, cudaStream_t stream) {
  dim3 grid((Nout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<ALoad><<<grid, kThreads, 0, stream>>>(A, W, M, K, Nout, epi,
                                                    stats);
}

inline int gemm_row_blocks(int M) { return (M + kBM - 1) / kBM; }

}  // namespace

#define PDGN_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t _e = cudaGetLastError();        \
    if (_e != cudaSuccess) return (int)_e;      \
  } while (0)
