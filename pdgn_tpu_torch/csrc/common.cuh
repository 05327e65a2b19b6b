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
// bias and addend may be null.
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
    if (bias) v += bias[(size_t)(bias_div ? row / bias_div : 0) * Nout + col];
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

// ------------------------------------------------------ transposed GEMM
// out[Kd, Nout] = sum over r < R of A(r, i) * B(r, o): the weight gradient
// of a product whose rows are the reduction. The R rows are cut into
// splits of kSplitRows; each block owns one 64x64 output tile of one split
// and writes its partial to scratch (splits, Kd, Nout); column_reduce then
// adds the splits in a fixed order, so the result is deterministic.
constexpr int kSplitRows = 4096;

inline int tn_splits(long long R) {
  return (int)((R + kSplitRows - 1) / kSplitRows);
}

template <class ALoad, class BLoad>
__global__ void __launch_bounds__(kThreads)
gemm_tn_kernel(ALoad A, BLoad Bm, long long R, int Kd, int Nout,
               float* __restrict__ scratch) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * kBM;
  const int o0 = blockIdx.x * kBN;
  const long long r_begin = (long long)blockIdx.z * kSplitRows;
  long long r_end = r_begin + kSplitRows;
  if (r_end > R) r_end = R;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int e = tid + q * kThreads;
      int rr = e / kBM, ii = e % kBM;
      long long gr = r0 + rr;
      int gi = i0 + ii;
      As[rr][ii] = (gr < r_end && gi < Kd) ? A.load(gr, gi) : 0.f;
      int gc = o0 + ii;
      Bs[rr][ii] = (gr < r_end && gc < Nout) ? Bm.load(gr, gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kBK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = scratch + (size_t)blockIdx.z * Kd * Nout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gi = i0 + ty + 16 * i;
    if (gi >= Kd) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = o0 + tx + 16 * j;
      if (gc < Nout) o[(size_t)gi * Nout + gc] = acc[i][j];
    }
  }
}

// scratch holds tn_splits(R) * Kd * Nout floats
template <class ALoad, class BLoad>
inline void gemm_tn(ALoad A, BLoad Bm, long long R, int Kd, int Nout,
                    float* scratch, float* out, cudaStream_t stream) {
  int splits = tn_splits(R);
  dim3 grid((Nout + kBN - 1) / kBN, (Kd + kBM - 1) / kBM, splits);
  gemm_tn_kernel<ALoad, BLoad><<<grid, kThreads, 0, stream>>>(
      A, Bm, R, Kd, Nout, scratch);
  column_reduce(scratch, splits, Kd * Nout, out, stream);
}

// ------------------------------------------------------- column sums
// out[c, col] = sum over the rows [c*chunk, (c+1)*chunk) of A(row, col), one
// thread per (chunk, column), rows in ascending order (deterministic).
template <class ALoad>
__global__ void chunk_colsum_kernel(ALoad A, long long rows, int ncol,
                                    int chunk, float* __restrict__ out) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  long long r0 = (long long)blockIdx.y * chunk;
  long long r1 = r0 + chunk;
  if (r1 > rows) r1 = rows;
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += A.load(r, col);
  out[(size_t)blockIdx.y * ncol + col] = s;
}

template <class ALoad>
inline void chunk_colsum(ALoad A, long long rows, int ncol, int chunk,
                         float* out, cudaStream_t stream) {
  dim3 grid((ncol + 127) / 128, (unsigned)((rows + chunk - 1) / chunk));
  chunk_colsum_kernel<ALoad><<<grid, 128, 0, stream>>>(A, rows, ncol, chunk,
                                                       out);
}

// --------------------------------------------- reverse adjacency (CSR)
// A neighbour table idx (B, M, K) names, for every entry e = (b, m, slot),
// a row idx[e] in [0, N) of sample b, each row at most once per m. The
// reverse adjacency lists, for every target row q = b*N + n, the entries
// that name it, in ascending e: entries[offsets[q] .. offsets[q+1]). A
// counting sort builds it: integer atomics count and place the entries, and
// one block per row sorts its list, so every sum over a list is taken in the
// same order on every run (no float atomics anywhere). A row's list holds
// at most M entries; kNN graphs have hub rows named by most of the sample.
__global__ void adj_count_kernel(const int* __restrict__ idx, long long total,
                                 int MK, int N, int* __restrict__ count) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int b = (int)(e / MK);
  atomicAdd(&count[(size_t)b * N + idx[e]], 1);
}

// exclusive scan of n counts into offsets (n + 1), one block of 1024
// threads, each scanning a contiguous chunk serially
__global__ void __launch_bounds__(1024)
adj_scan_kernel(const int* __restrict__ count, int n, int* __restrict__ offsets,
                int* __restrict__ cursor) {
  __shared__ int part[1024];
  const int t = threadIdx.x;
  const int per = (n + 1023) / 1024;
  const int a = min(n, t * per), z = min(n, a + per);
  int s = 0;
  for (int i = a; i < z; ++i) s += count[i];
  part[t] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan of the 1024 chunk sums
  for (int d = 1; d < 1024; d <<= 1) {
    int v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - s;
  for (int i = a; i < z; ++i) {
    offsets[i] = run;
    cursor[i] = run;
    run += count[i];
  }
  if (t == 1023) offsets[n] = part[1023];
}

__global__ void adj_fill_kernel(const int* __restrict__ idx, long long total,
                                int MK, int N, int* __restrict__ cursor,
                                int* __restrict__ entries) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int b = (int)(e / MK);
  int pos = atomicAdd(&cursor[(size_t)b * N + idx[e]], 1);
  entries[pos] = (int)e;
}

constexpr int kSortThreads = 128;

// one block per row: bitonic sort of its list in shared memory (padded to a
// power of two with INT_MAX); rows of zero or one entry return at once
__global__ void __launch_bounds__(kSortThreads)
adj_sort_kernel(const int* __restrict__ offsets, int* __restrict__ entries) {
  extern __shared__ int s_list[];
  const int q = blockIdx.x;
  const int a = offsets[q], d = offsets[q + 1] - a;
  if (d < 2) return;
  int P = 1;
  while (P < d) P <<= 1;
  for (int i = threadIdx.x; i < P; i += kSortThreads)
    s_list[i] = i < d ? entries[a + i] : 0x7fffffff;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += kSortThreads) {
        int j = i ^ stride;
        if (j > i) {
          int u = s_list[i], v = s_list[j];
          if ((u > v) == ((i & size) == 0)) {
            s_list[i] = v;
            s_list[j] = u;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < d; i += kSortThreads)
    entries[a + i] = s_list[i];
}

// count/cursor: scratch of B*N ints each; offsets B*N + 1; entries B*M*K.
// Entry ids are global (b*M*K + m*K + slot), so B*M*K must fit an int, and
// a row's list (at most M entries, padded to a power of two) must fit one
// block's shared memory: M <= 32768.
inline cudaError_t reverse_adjacency(const int* idx, int B, int M, int K,
                                     int N, int* count, int* cursor,
                                     int* offsets, int* entries,
                                     cudaStream_t stream) {
  const long long total = (long long)B * M * K;
  const int n = B * N;
  int cap = 1;
  while (cap < M) cap <<= 1;
  const int smem = cap * (int)sizeof(int);
  if (cap > 32768) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      adj_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(count, 0, sizeof(int) * n, stream);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  adj_count_kernel<<<blocks, threads, 0, stream>>>(idx, total, M * K, N,
                                                   count);
  adj_scan_kernel<<<1, 1024, 0, stream>>>(count, n, offsets, cursor);
  adj_fill_kernel<<<blocks, threads, 0, stream>>>(idx, total, M * K, N,
                                                  cursor, entries);
  adj_sort_kernel<<<n, kSortThreads, smem, stream>>>(offsets, entries);
  return cudaGetLastError();
}

}  // namespace

#define PDGN_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t _e = cudaGetLastError();        \
    if (_e != cudaSuccess) return (int)_e;      \
  } while (0)
