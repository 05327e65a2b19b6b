// Shared device code of the port's kernels: the LeakyReLU of the generator,
// a deterministic cross-block column reduction, per-chunk column sums, and
// the reverse adjacency (CSR) of a neighbour table. The fp32 products run on
// the tensor cores through tf32x3_gemm.cuh.
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

// A (M, K) row-major, read one element at a time
struct PlainA {
  const float* a;
  int K;
  __device__ __forceinline__ float load(long long row, int kk) const {
    return a[(size_t)row * K + kk];
  }
};

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
// at most M entries; kNN graphs have hub rows named by many of the sample.
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
constexpr int kSortSmemCap = 8192;  // list entries sorted in shared memory

// Ascending sort of list[0, d) by the bitonic network whose comparators all
// put the smaller value first (the flip form: the first step of each merge
// pairs i with i ^ (size - 1)). Positions d .. P-1 of the padded length P
// are an implicit +inf and never move, so the list sorts in place.
__device__ void sort_list(int* list, int d) {
  int P = 1;
  while (P < d) P <<= 1;
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int flip = stride == size >> 1 ? size - 1 : stride;
      for (int i = threadIdx.x; i < d; i += kSortThreads) {
        const int j = i ^ flip;
        if (j > i && j < d) {
          const int u = list[i], v = list[j];
          if (u > v) {
            list[i] = v;
            list[j] = u;
          }
        }
      }
      __syncthreads();
    }
  }
}

// one block per row; rows of zero or one entry return at once. A list of
// at most kSortSmemCap entries sorts in shared memory, a longer one (a hub
// row named by more centers) in place in device memory.
__global__ void __launch_bounds__(kSortThreads)
adj_sort_kernel(const int* __restrict__ offsets, int* __restrict__ entries,
                int cap) {
  extern __shared__ int s_list[];
  const int q = blockIdx.x;
  const int a = offsets[q], d = offsets[q + 1] - a;
  if (d < 2) return;
  if (d > cap) {
    sort_list(entries + a, d);
    return;
  }
  for (int i = threadIdx.x; i < d; i += kSortThreads)
    s_list[i] = entries[a + i];
  __syncthreads();
  sort_list(s_list, d);
  for (int i = threadIdx.x; i < d; i += kSortThreads)
    entries[a + i] = s_list[i];
}

// count/cursor: scratch of B*N ints each; offsets B*N + 1; entries B*M*K.
// Entry ids are global (b*M*K + m*K + slot), so B*M*K must fit an int.
inline cudaError_t reverse_adjacency(const int* idx, int B, int M, int K,
                                     int N, int* count, int* cursor,
                                     int* offsets, int* entries,
                                     cudaStream_t stream) {
  const long long total = (long long)B * M * K;
  const int n = B * N;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  const int cap = M < kSortSmemCap ? M : kSortSmemCap;
  const int smem = cap * (int)sizeof(int);
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
  adj_sort_kernel<<<n, kSortThreads, smem, stream>>>(offsets, entries, cap);
  return cudaGetLastError();
}

}  // namespace

#define PDGN_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t _e = cudaGetLastError();        \
    if (_e != cudaSuccess) return (int)_e;      \
  } while (0)
