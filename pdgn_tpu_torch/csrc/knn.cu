// Exact k-nearest-neighbour selection, alone and fused with the neighbour
// gather, for Hopper (sm_90a).
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/knn.py::_kernel (launcher
// _knn_topk, entry knn_topk) and pdgn_tpu/ops/pallas/knn.py::_gather_kernel
// (entry knn_gather).
//
// knn_topk: queries (B, M, C), database (B, N, C) -> (B, M, k) int32, the k
// smallest distances ascending, the lower index first on ties. knn_gather:
// self-kNN of x (B, M, C) for k+1, slot 0 (the row minimum) dropped, then the
// k neighbours' rows copied into nbr (B, M, k, C). The same selection
// (knn_select, declared in knn.cuh) builds the edge-conv head's graph in
// edge_head.cu: self-kNN for k+1, slot 0 dropped, always the norm expansion.
//
// Distances, as the TPU kernel takes them:
//   C <= 4: fp32 direct differences, channel by channel from 0, each product
//     and sum rounded on its own (__fmul_rn/__fadd_rn, never contracted into
//     an FMA), so the plain version's elementwise PyTorch arithmetic gives the
//     same bits and both select the same neighbours;
//   C > 4: the norm expansion (|q|^2 - 2<q,y>) + |y|^2 in the rounding order
//     of the port's pairwise_sqdist (the exact graph's order; the TPU kernel's
//     bf16 MXU product is its fast regime and is not ported).
//
// What bounds it on the H100: operations. At the point-ops path's widest call
// (35 x 1024 queries of C=256 against themselves) the distances are 18.8
// GFLOP against 37 MB of features; the fp32 FMA rate (67 TFLOP/s) is the
// ceiling. At C=3 the work is ~9 operations a (query, point) pair and the
// selection's compares and insertions are the time.
//
// The simple design: one thread owns one query row (128 a block) and keeps
// its best K in ascending order by insertion with a strict < (the first index
// seen stays first on ties), while the sample's database rows stream through
// shared memory in tiles:
//   - direct (C <= 4): 256-row tiles of float4 (zero-padded channels add an
//     exact 0), one distance a row;
//   - norm (C > 4): 64-row tiles in 32-channel chunks, stored channel-major
//     so a thread reads four rows' values in one broadcast float4; 64 dot
//     products a thread accumulate in registers, the norms come from the same
//     chunks.
// The list lives in registers for K <= 32 (template instances of 16, 24 and
// 32 slots; a list longer than K still holds the K best first), and in
// dynamic shared memory, one strided column a thread, for 32 < K <= 128.
// There is no M % 128 rule (the TPU's tile): the last block masks its rows.
// knn_gather writes its indices, then the block copies the selected rows with
// one warp a row (float4 lanes when C % 4 == 0): indexed loads, so nbr is
// exact, where the TPU gathers by one-hot bf16 hi/lo MXU products.
#include "common.cuh"
#include "knn.cuh"

#include <math.h>

namespace {

constexpr int kTQ = 128;   // query rows per block, one per thread
constexpr int kTD = 256;   // database rows per shared tile, direct path
constexpr int kTN = 64;    // database rows per shared tile, norm path
constexpr int kCK = 32;    // channels per shared chunk, norm path
constexpr int kMaxK = 128;

// The best KP (distance, index) pairs in registers, ascending.
template <int KP>
struct TopList {
  float d[KP];
  int i[KP];

  __device__ __forceinline__ TopList(float*, int, int) {
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      d[s] = INFINITY;
      i[s] = 0;
    }
  }

  __device__ __forceinline__ void push(float v, int j) {
    if (!(v < d[KP - 1])) return;
    d[KP - 1] = v;
    i[KP - 1] = j;
    // strict <: the new entry passes only larger distances
#pragma unroll
    for (int s = KP - 1; s > 0; --s) {
      if (d[s] < d[s - 1]) {
        float td = d[s]; d[s] = d[s - 1]; d[s - 1] = td;
        int ti = i[s]; i[s] = i[s - 1]; i[s - 1] = ti;
      }
    }
  }

  // out[s - drop] = index of slot s for drop <= s < K
  __device__ __forceinline__ void write(int* out, int drop, int K) const {
#pragma unroll
    for (int s = 0; s < KP; ++s)
      if (s >= drop && s < K) out[s - drop] = i[s];
  }
};

// The best K pairs in dynamic shared memory: slot s of thread t at
// [s * kTQ + t] (distances, then indices), so a warp's accesses to one slot
// fall on 32 different banks.
template <>
struct TopList<0> {
  float* d;
  int* i;
  int K;

  __device__ __forceinline__ TopList(float* smem, int K_, int t)
      : d(smem + t), i(reinterpret_cast<int*>(smem) + K_ * kTQ + t), K(K_) {
    for (int s = 0; s < K; ++s) {
      d[s * kTQ] = INFINITY;
      i[s * kTQ] = 0;
    }
  }

  __device__ __forceinline__ void push(float v, int j) {
    if (!(v < d[(K - 1) * kTQ])) return;
    int s = K - 1;
    while (s > 0 && d[(s - 1) * kTQ] > v) {
      d[s * kTQ] = d[(s - 1) * kTQ];
      i[s * kTQ] = i[(s - 1) * kTQ];
      --s;
    }
    d[s * kTQ] = v;
    i[s * kTQ] = j;
  }

  __device__ __forceinline__ void write(int* out, int drop, int K_) const {
    for (int s = drop; s < K_; ++s) out[s - drop] = i[s * kTQ];
  }
};

__device__ __forceinline__ float4 load_row4(const float* p, int C) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = p[0];
  if (C > 1) v.y = p[1];
  if (C > 2) v.z = p[2];
  if (C > 3) v.w = p[3];
  return v;
}

// C <= 4: ((d0 + d1) + d2) + d3 with d_c = (q_c - y_c)^2, every step rounded
template <class List>
__device__ __forceinline__ void scan_direct(const float* qb, const float* db,
                                            int M, int N, int C, int q,
                                            List& list) {
  __shared__ float4 sP[kTD];
  const int t = threadIdx.x;
  const float4 qv = q < M ? load_row4(qb + (size_t)q * C, C)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < N; j0 += kTD) {
    for (int r = t; r < kTD; r += kTQ) {
      const int j = j0 + r;
      sP[r] = j < N ? load_row4(db + (size_t)j * C, C)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int n = min(kTD, N - j0);
    for (int r = 0; r < n; ++r) {
      const float4 y = sP[r];
      float e = __fsub_rn(qv.x, y.x);
      float d = __fmul_rn(e, e);
      e = __fsub_rn(qv.y, y.y);
      d = __fadd_rn(d, __fmul_rn(e, e));
      e = __fsub_rn(qv.z, y.z);
      d = __fadd_rn(d, __fmul_rn(e, e));
      e = __fsub_rn(qv.w, y.w);
      d = __fadd_rn(d, __fmul_rn(e, e));
      list.push(d, j0 + r);
    }
    __syncthreads();
  }
}

// C > 4: (|q|^2 - 2<q,y>) + |y|^2, every sum an fmaf chain over ascending
// channels (zero padding adds an exact 0), so a row's distance to itself is 0
template <class List>
__device__ __forceinline__ void scan_norm(const float* qb, const float* db,
                                          int M, int N, int C, int q0,
                                          List& list) {
  __shared__ float sQ[kTQ][kCK + 1];
  __shared__ __align__(16) float sD[kCK][kTN + 4];
  __shared__ float sSq[kTN];
  const int t = threadIdx.x;
  float qsq = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTN) {
    float acc[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[j] = 0.f;
    float ysq = 0.f;
    for (int c0 = 0; c0 < C; c0 += kCK) {
      for (int e = t; e < kTQ * kCK; e += kTQ) {
        const int r = e / kCK, c = e % kCK;
        const int gq = q0 + r, gc = c0 + c;
        sQ[r][c] = (gq < M && gc < C) ? qb[(size_t)gq * C + gc] : 0.f;
      }
      for (int e = t; e < kTN * kCK; e += kTQ) {
        const int r = e / kCK, c = e % kCK;
        const int gj = j0 + r, gc = c0 + c;
        sD[c][r] = (gj < N && gc < C) ? db[(size_t)gj * C + gc] : 0.f;
      }
      __syncthreads();
      if (j0 == 0) {
        for (int c = 0; c < kCK; ++c) qsq = fmaf(sQ[t][c], sQ[t][c], qsq);
      }
      if (t < kTN) {
        for (int c = 0; c < kCK; ++c) ysq = fmaf(sD[c][t], sD[c][t], ysq);
      }
      for (int c = 0; c < kCK; ++c) {
        const float qv = sQ[t][c];
        const float4* row = reinterpret_cast<const float4*>(sD[c]);
#pragma unroll
        for (int j4 = 0; j4 < kTN / 4; ++j4) {
          const float4 y = row[j4];
          acc[4 * j4] = fmaf(qv, y.x, acc[4 * j4]);
          acc[4 * j4 + 1] = fmaf(qv, y.y, acc[4 * j4 + 1]);
          acc[4 * j4 + 2] = fmaf(qv, y.z, acc[4 * j4 + 2]);
          acc[4 * j4 + 3] = fmaf(qv, y.w, acc[4 * j4 + 3]);
        }
      }
      __syncthreads();
    }
    if (t < kTN) sSq[t] = ysq;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (j0 + j < N) list.push((qsq - 2.f * acc[j]) + sSq[j], j0 + j);
    }
    __syncthreads();
  }
}

// One block: kTQ query rows of sample blockIdx.y; slots drop..K-1 to idx.
// kGather: then the selected db rows' copy into nbr.
template <bool kDirect, int KP, bool kGather>
__global__ void __launch_bounds__(kTQ)
knn_kernel(const float* __restrict__ q, const float* __restrict__ db, int M,
           int N, int C, int K, int drop, int* idx,
           float* __restrict__ nbr) {
  extern __shared__ float s_top[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int t = threadIdx.x;
  const float* qb = q + (size_t)b * M * C;
  const float* dbb = db + (size_t)b * N * C;
  TopList<KP> list(s_top, K, t);
  if constexpr (kDirect) {
    scan_direct(qb, dbb, M, N, C, q0 + t, list);
  } else {
    scan_norm(qb, dbb, M, N, C, q0, list);
  }
  const int k = K - drop;
  if (q0 + t < M) list.write(idx + ((size_t)b * M + q0 + t) * k, drop, K);
  if constexpr (kGather) {
    // the block's idx rows are written; __syncthreads makes them visible
    __syncthreads();
    const int rows = min(kTQ, M - q0) * k;
    const int warp = t / 32, lane = t % 32;
    const int* ib = idx + ((size_t)b * M + q0) * k;
    float* ob = nbr + ((size_t)b * M + q0) * k * C;
    for (int r = warp; r < rows; r += kTQ / 32) {
      const float* src = dbb + (size_t)ib[r] * C;
      float* dst = ob + (size_t)r * C;
      if (C % 4 == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int c = lane; c < C / 4; c += 32) d4[c] = s4[c];
      } else {
        for (int c = lane; c < C; c += 32) dst[c] = src[c];
      }
    }
  }
}

template <bool kDirect, int KP, bool kGather>
cudaError_t launch_one(const float* q, const float* db, int B, int M, int N,
                       int C, int K, int drop, int* idx, float* nbr,
                       cudaStream_t stream) {
  auto kernel = knn_kernel<kDirect, KP, kGather>;
  const int smem = KP == 0 ? 2 * K * kTQ * (int)sizeof(float) : 0;
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((M + kTQ - 1) / kTQ, B);
  kernel<<<grid, kTQ, smem, stream>>>(q, db, M, N, C, K, drop, idx, nbr);
  return cudaGetLastError();
}

template <int KP, bool kGather>
cudaError_t launch_list(const float* q, const float* db, int B, int M, int N,
                        int C, int K, int drop, bool direct, int* idx,
                        float* nbr, cudaStream_t stream) {
  if (direct)
    return launch_one<true, KP, kGather>(q, db, B, M, N, C, K, drop, idx, nbr,
                                         stream);
  return launch_one<false, KP, kGather>(q, db, B, M, N, C, K, drop, idx, nbr,
                                        stream);
}

template <bool kGather>
cudaError_t launch(const float* q, const float* db, int B, int M, int N,
                   int C, int K, int drop, bool direct, int* idx, float* nbr,
                   cudaStream_t stream) {
  if (K <= 16)
    return launch_list<16, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                    nbr, stream);
  if (K <= 24)
    return launch_list<24, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                    nbr, stream);
  if (K <= 32)
    return launch_list<32, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                    nbr, stream);
  return launch_list<0, kGather>(q, db, B, M, N, C, K, drop, direct, idx, nbr,
                                 stream);
}

}  // namespace

namespace pdgn {

cudaError_t knn_select(const float* q, const float* db, int B, int M, int N,
                       int C, int K, int drop, bool direct, int* idx,
                       float* nbr, cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1 || K < 1 || K > kMaxK || K > N || B > 65535 ||
      drop < 0 || drop >= K || (direct && C > 4))
    return cudaErrorInvalidValue;
  if (nbr != nullptr)
    return launch<true>(q, db, B, M, N, C, K, drop, direct, idx, nbr, stream);
  return launch<false>(q, db, B, M, N, C, K, drop, direct, idx, nullptr,
                       stream);
}

}  // namespace pdgn

extern "C" {

// queries (B, M, C), database (B, N, C) fp32 contiguous; idx (B, M, k).
int pdgn_knn_topk(const float* queries, const float* database, int B, int M,
                  int N, int C, int k, int* idx, cudaStream_t stream) {
  return (int)pdgn::knn_select(queries, database, B, M, N, C, k, 0, C <= 4,
                               idx, nullptr, stream);
}

// x (B, M, C) fp32 contiguous; idx (B, M, k); nbr (B, M, k, C).
int pdgn_knn_gather(const float* x, int B, int M, int C, int k, int* idx,
                    float* nbr, cudaStream_t stream) {
  return (int)pdgn::knn_select(x, x, B, M, M, C, k + 1, 1, C <= 4, idx, nbr,
                               stream);
}

}  // extern "C"
