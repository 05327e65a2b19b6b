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
// edge_head.cu (self-kNN for k+1, slot 0 dropped, always the norm
// expansion) and local_stats.cu's neighbourhoods.
//
// Distances, as the TPU kernel takes them:
//   C <= 4: fp32 direct differences, channel by channel from 0, each product
//     and sum rounded on its own (direct_dist in knn.cuh: __fmul_rn/__fadd_rn,
//     never contracted into an FMA), so the plain version's elementwise
//     PyTorch arithmetic gives the same bits and both select the same
//     neighbours, and local_stats.cu's backward recomputes them exactly;
//   C > 4: the norm expansion (|q|^2 - 2<q,y>) + |y|^2, every sum an fmaf
//     chain over ascending channels (the rounding of the port's earlier
//     kernel, so the head's graph keeps its bits; the TPU kernel's bf16 MXU
//     product is its fast regime and is not ported). 3xTF32 tensor-core
//     products would change the distances' bits and so the graph at
//     near-ties; they are not taken.
//
// What bounds it on the H100: operations. At the point-ops path's widest
// call (35 x 1024 queries of C=256 against themselves) the distances are
// 18.8 GFLOP against 37 MB of features; the fp32 FMA rate (67 TFLOP/s) is
// the ceiling. At C=3 a distance is ~9 operations and the selection's
// compares and insertions are the time.
//
// The design: one warp per query selects (the WarpSelect idea of Johnson,
// Douze and Jegou, "Billion-scale similarity search with GPUs",
// arXiv:1702.08734, in its simplest form). Its sorted list of the best
// K keys is spread over the lanes, slots lane*KP .. lane*KP + KP-1 in the KP
// registers of that lane (KP = ceil(K / 32) <= 4). Candidates arrive 32 at
// a time, one a lane in ascending index; a __ballot_sync filters them
// against the current K-th key, each survivor, taken in lane order, is
// inserted (ballots count the keys before it, and the slots behind it shift
// up one, within a lane's registers and by one __shfl_up_sync across
// lanes), and the K-th key is broadcast again once a batch of 32: a
// survivor that an earlier one of its batch pushed past slot K-1 lands in
// slots that are never read. Shuffles, not arithmetic, limit an
// insertion, four a survivor. An empty list takes its first KP*32
// candidates at once when KP is a power of two: one bitonic sort in
// registers instead of a fill of insertions. Keys compare as
// (distance, index), so the lower index wins ties exactly as
// topk_ascending_idx does, whatever order candidates come in.
//   C <= 4: each lane computes its candidate's distance from the row it
//     loads itself (the 8 warps of a block read the same rows, through L1).
//     When the batch has too few queries to fill the card, the warps of a
//     block split N among them (up to 8 parts a query) and the first part's
//     warp merges the others' lists, staged in shared memory, by the same
//     filter and insertion.
//   C > 4: a block owns 64 queries, 8 a warp, and walks 128-row database
//     tiles: 32-channel chunks of both staged in shared memory
//     channel-major (float4 loads, 64 contiguous bytes a row; a warp's
//     transposing stores fall on 16 banks), the next chunk loaded into
//     registers while this one is used. A lane holds its warp's 8 queries x
//     4 rows in registers: per channel two broadcast float4 loads of the
//     queries and one float4 of the rows feed 32 FMAs, so the FMA pipe, not
//     shared memory, sets the pace. The norms' sequential chains are spread
//     over every warp. The warp then offers its queries the distances
//     straight from its registers, 32 candidates a batch (rows 4 lane + e:
//     not in index order, which the keys make no matter).
// knn_gather's and the head's slot 0 is dropped at the write. knn_gather
// then copies each query's selected rows with its warp (float4 lanes when
// C % 4 == 0): indexed loads, so nbr is exact, where the TPU gathers by
// one-hot bf16 hi/lo MXU products.
#include "common.cuh"
#include "knn.cuh"

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;
constexpr int kKnnWarps = 8;
constexpr int kKnnThreads = 32 * kKnnWarps;
constexpr int kTQ = 64;                // norm path: queries a block
constexpr int kQW = kTQ / kKnnWarps;   // norm path: queries a warp
constexpr int kTN = 128;               // norm path: database rows a tile
constexpr int kCK = 32;                // norm path: channels a chunk
// norm path: staged row lengths (float4-aligned; a warp's transposing
// stores fall on 16 banks)
constexpr int kLDQ = kTQ + 4;
constexpr int kLDY = kTN + 4;
// direct path: split N while B*M*split is below this many warps (two waves
// of 64 warps on each of 132 SMs)
constexpr long long kFillWarps = 2LL * 132 * 64;

// (distance, index) order: the smaller distance first, the lower index on
// ties (a NaN distance never passes)
__device__ __forceinline__ bool key_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// The best K keys of one query, ascending, held by a warp: slot lane*KP + r
// in d[r], i[r] (a lane's KP slots are consecutive, so a shift by one slot
// moves registers within a lane and crosses lanes once, by one
// __shfl_up_sync); kd, ki are slot K-1's key (warp-uniform). Empty slots
// hold (+inf, INT_MAX), which every real key passes.
template <int KP>
struct WarpList {
  float d[KP];
  int i[KP];
  float kd;
  int ki;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      d[r] = INFINITY;
      i[r] = INT_MAX;
    }
    kd = INFINITY;
    ki = INT_MAX;
  }

  // insert (v, j) at its place, dropping the last slot's key (a key that
  // sorts after slot K-1 lands beyond it: slots K.. are never read)
  __device__ __forceinline__ void insert(float v, int j) {
    const int lane = threadIdx.x & 31;
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KP; ++r)
      pos += __popc(__ballot_sync(kFull, key_less(d[r], i[r], v, j)));
    // the previous lane's last slot (lane 0 reads its own, unused)
    const float pd = __shfl_up_sync(kFull, d[KP - 1], 1);
    const int pi = __shfl_up_sync(kFull, i[KP - 1], 1);
#pragma unroll
    for (int r = KP - 1; r >= 0; --r) {
      const int p = lane * KP + r;
      if (p > pos) {
        d[r] = r > 0 ? d[r - 1] : pd;
        i[r] = r > 0 ? i[r - 1] : pi;
      } else if (p == pos) {
        d[r] = v;
        i[r] = j;
      }
    }
  }

  // The list's first fill, KP a power of two: candidate (v[r], j[r]) into
  // slot lane*KP + r, then a bitonic sort of the KP*32 slots in registers
  // (the flip form: every compare-exchange puts the smaller key in the
  // lower slot; a partner in another lane comes by __shfl_xor_sync). One
  // sort instead of up to KP*32 insertions into an empty list.
  __device__ __forceinline__ void fill_sorted(const float (&v)[KP],
                                              const int (&j)[KP], int K) {
    static_assert((KP & (KP - 1)) == 0, "KP must be a power of two");
    constexpr int kLog = KP == 1 ? 0 : KP == 2 ? 1 : 2;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      d[r] = v[r];
      i[r] = j[r];
    }
#pragma unroll
    for (int size = 2; size <= KP * 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int flip = stride == size >> 1 ? size - 1 : stride;
        const int lx = flip >> kLog;
        float nd[KP];
        int ni[KP];
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          const int rr = r ^ (flip & (KP - 1));
          const float pd = lx ? __shfl_xor_sync(kFull, d[rr], lx) : d[rr];
          const int pi = lx ? __shfl_xor_sync(kFull, i[rr], lx) : i[rr];
          const int p = lane * KP + r;
          const bool keep = (p < (p ^ flip)) == key_less(d[r], i[r], pd, pi);
          nd[r] = keep ? d[r] : pd;
          ni[r] = keep ? i[r] : pi;
        }
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          d[r] = nd[r];
          i[r] = ni[r];
        }
      }
    }
    update_kth(K);
  }

  // slot K-1's key to every lane
  __device__ __forceinline__ void update_kth(int K) {
    const int kr = (K - 1) % KP;
    float td = d[0];
    int ti = i[0];
#pragma unroll
    for (int r = 1; r < KP; ++r) {
      if (r == kr) {
        td = d[r];
        ti = i[r];
      }
    }
    kd = __shfl_sync(kFull, td, (K - 1) / KP);
    ki = __shfl_sync(kFull, ti, (K - 1) / KP);
  }

  // one candidate a lane: the ballot filter against slot K-1's key, then
  // the survivors inserted in lane order and the K-th key updated once
  __device__ __forceinline__ void offer(float v, int j, int K) {
    unsigned m = __ballot_sync(kFull, key_less(v, j, kd, ki));
    if (!m) return;
    do {
      const int l = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(kFull, v, l), __shfl_sync(kFull, j, l));
    } while (m);
    update_kth(K);
  }

  // out[s - drop] = index of slot s for drop <= s < K
  __device__ __forceinline__ void write(int* out, int drop, int K) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int p = lane * KP + r;
      if (p >= drop && p < K) out[p - drop] = i[r];
    }
  }

  // the rows of slots drop..K-1 of db into out (K - drop, C), one warp
  __device__ __forceinline__ void gather(const float* __restrict__ db, int C,
                                         int drop, int K,
                                         float* __restrict__ out) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      for (int l = 0; l < 32; ++l) {
        const int p = l * KP + r;
        const int j = __shfl_sync(kFull, i[r], l);
        if (p < drop || p >= K) continue;
        const float* src = db + (size_t)j * C;
        float* dst = out + (size_t)(p - drop) * C;
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
};

// Direct path: warp w of a block takes query blockIdx.x * (8 / split) +
// w / split of sample blockIdx.y and part w % split of its 32-row chunks.
template <int KP, bool kGather>
__global__ void __launch_bounds__(kKnnThreads)
knn_direct_kernel(const float* __restrict__ q, const float* __restrict__ db,
                  int M, int N, int C, int K, int drop, int split,
                  int* __restrict__ idx, float* __restrict__ nbr) {
  __shared__ float sMd[kKnnWarps][kMaxK];
  __shared__ int sMi[kKnnWarps][kMaxK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * (kKnnWarps / split) + warp / split;
  const int part = warp % split;
  const bool live = qi < M;
  const float* dbb = db + (size_t)b * N * C;
  WarpList<KP> list;
  list.init();
  if (live) {
    const float4 qv = pdgn::load_row4(q + ((size_t)b * M + qi) * C, C);
    const int chunks = (N + 31) / 32;
    const int c1 = (part + 1) * chunks / split;
    int c = part * chunks / split;
    if constexpr ((KP & (KP - 1)) == 0) {
      // the part's first KP chunks, KP consecutive rows a lane
      const int end = min(c1 * 32, N);
      float v[KP];
      int jj[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        const int j = c * 32 + lane * KP + r;
        v[r] = j < end ? pdgn::direct_dist(
                             qv, pdgn::load_row4(dbb + (size_t)j * C, C))
                       : INFINITY;
        jj[r] = j < end ? j : INT_MAX;
      }
      list.fill_sorted(v, jj, K);
      c += KP;
    }
    for (; c < c1; ++c) {
      const int j = c * 32 + lane;
      float v = INFINITY;
      int jj = INT_MAX;
      if (j < N) {
        v = pdgn::direct_dist(qv, pdgn::load_row4(dbb + (size_t)j * C, C));
        jj = j;
      }
      list.offer(v, jj, K);
    }
  }
  if (split > 1) {
    if (part > 0) {
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        sMd[warp][lane * KP + r] = list.d[r];
        sMi[warp][lane * KP + r] = list.i[r];
      }
    }
    __syncthreads();
    if (part == 0 && live) {
      for (int s = 1; s < split; ++s) {
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          const int p = r * 32 + lane;  // any order: keys decide
          const bool in = p < K;
          list.offer(in ? sMd[warp + s][p] : INFINITY,
                     in ? sMi[warp + s][p] : INT_MAX, K);
        }
      }
    }
  }
  if (part != 0 || !live) return;
  const size_t row = (size_t)b * M + qi;
  list.write(idx + row * (K - drop), drop, K);
  if constexpr (kGather)
    list.gather(dbb, C, drop, K, nbr + row * (K - drop) * C);
}

// A thread's share of one 32-channel chunk of the 64 queries and the 128
// database rows: rows t / 4 (and 64 + t / 4 of the database), channels
// 4 (t % 4) + 16 i .. + 3 (i = 0, 1).
struct Chunk {
  float4 q[2], y[2][2];
};

// row `row` of a (rows, C) matrix, channels gc .. gc + 3 (zeros outside);
// vec: C % 4 == 0 and the matrix 16-byte aligned
__device__ __forceinline__ float4 load_chunk4(const float* base, int row,
                                              int rows, int gc, int C,
                                              bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || gc >= C) return v;
  const float* p = base + (size_t)row * C + gc;
  if (vec) return *reinterpret_cast<const float4*>(p);
  v.x = p[0];
  if (gc + 1 < C) v.y = p[1];
  if (gc + 2 < C) v.z = p[2];
  if (gc + 3 < C) v.w = p[3];
  return v;
}

__device__ __forceinline__ void load_chunk(const float* qb, const float* dbb,
                                           int M, int N, int C, int q0,
                                           int j0, int c0, bool vec,
                                           Chunk& ch) {
  const int r = threadIdx.x >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gc = c0 + 4 * ((threadIdx.x & 3) + 4 * i);
    ch.q[i] = load_chunk4(qb, q0 + r, M, gc, C, vec);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ch.y[h][i] = load_chunk4(dbb, j0 + r + 64 * h, N, gc, C, vec);
  }
}

__device__ __forceinline__ void store_col(float* s, int ld, int c, int r,
                                          float4 v) {
  s[c * ld + r] = v.x;
  s[(c + 1) * ld + r] = v.y;
  s[(c + 2) * ld + r] = v.z;
  s[(c + 3) * ld + r] = v.w;
}

// Norm path: kTQ queries of sample blockIdx.y against every database tile.
// Warp w computes and selects queries 8w .. 8w+7; lane l rows 4l .. 4l+3 of
// each tile.
template <int KP, bool kGather>
__global__ void __launch_bounds__(kKnnThreads)
knn_norm_kernel(const float* __restrict__ q, const float* __restrict__ db,
                int M, int N, int C, int K, int drop, bool vec,
                int* __restrict__ idx, float* __restrict__ nbr) {
  __shared__ __align__(16) float sQ[kCK * kLDQ];
  __shared__ __align__(16) float sY[kCK * kLDY];
  __shared__ float sQsq[kTQ];
  __shared__ float sYsq[kTN];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const float* qb = q + (size_t)b * M * C;
  const float* dbb = db + (size_t)b * N * C;
  const int nch = (C + kCK - 1) / kCK;

  WarpList<KP> list[kQW];
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) list[qq].init();

  Chunk ch;
  load_chunk(qb, dbb, M, N, C, q0, 0, 0, vec, ch);
  // the norms' chains: query t / 4 on lanes t % 4 == 1 (first tile only),
  // row t / 2 on even lanes, each over ascending channels
  float qsq = 0.f, ysq = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTN) {
    float acc[kQW][4];
#pragma unroll
    for (int a = 0; a < kQW; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
    ysq = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      __syncthreads();  // the previous chunk's readers are done
      {
        const int r = t >> 2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 4 * ((t & 3) + 4 * i);
          store_col(sQ, kLDQ, c, r, ch.q[i]);
          store_col(sY, kLDY, c, r, ch.y[0][i]);
          store_col(sY, kLDY, c, r + 64, ch.y[1][i]);
        }
      }
      __syncthreads();
      // the next chunk (this tile's, else the next tile's first) loads
      // while this one is used
      if (ci + 1 < nch)
        load_chunk(qb, dbb, M, N, C, q0, j0, (ci + 1) * kCK, vec, ch);
      else if (j0 + kTN < N)
        load_chunk(qb, dbb, M, N, C, q0, j0 + kTN, 0, vec, ch);
      if (j0 == 0 && (t & 3) == 1) {
        for (int c = 0; c < kCK; ++c) {
          const float v = sQ[c * kLDQ + (t >> 2)];
          qsq = fmaf(v, v, qsq);
        }
      }
      if ((t & 1) == 0) {
        for (int c = 0; c < kCK; ++c) {
          const float v = sY[c * kLDY + (t >> 1)];
          ysq = fmaf(v, v, ysq);
        }
      }
#pragma unroll 8
      for (int c = 0; c < kCK; ++c) {
        const float4 q0v =
            *reinterpret_cast<const float4*>(sQ + c * kLDQ + kQW * warp);
        const float4 q1v =
            *reinterpret_cast<const float4*>(sQ + c * kLDQ + kQW * warp + 4);
        const float4 yv = *reinterpret_cast<const float4*>(sY + c * kLDY + 4 * lane);
        const float qa[kQW] = {q0v.x, q0v.y, q0v.z, q0v.w,
                               q1v.x, q1v.y, q1v.z, q1v.w};
        const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int a = 0; a < kQW; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(qa[a], ya[e], acc[a][e]);
      }
    }
    if (j0 == 0 && (t & 3) == 1) sQsq[t >> 2] = qsq;
    if ((t & 1) == 0) sYsq[t >> 1] = ysq;
    __syncthreads();
    // the next tile's first __syncthreads comes after every warp has read
    // the norms here
    float yn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) yn[e] = sYsq[4 * lane + e];
    // the first tile fills a list whose KP is a power of two with its
    // first KP batches and sorts it, then offers the rest
    constexpr int kFill = (KP & (KP - 1)) == 0 ? KP : 0;
#pragma unroll
    for (int a = 0; a < kQW; ++a) {
      if (q0 + kQW * warp + a >= M) continue;
      const float qn = sQsq[kQW * warp + a];
      float v[4];
      int jj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 4 * lane + e;
        v[e] = j < N ? (qn - 2.f * acc[a][e]) + yn[e] : INFINITY;
        jj[e] = j < N ? j : INT_MAX;
      }
      int e0 = 0;
      if constexpr (kFill > 0) {
        if (j0 == 0) {
          float fv[KP];
          int fj[KP];
#pragma unroll
          for (int r = 0; r < KP; ++r) {
            fv[r] = v[r];
            fj[r] = jj[r];
          }
          list[a].fill_sorted(fv, fj, K);
          e0 = kFill;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e >= e0) list[a].offer(v[e], jj[e], K);
    }
  }

#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) {
    const int gq = q0 + warp * kQW + qq;
    if (gq >= M) continue;
    const size_t row = (size_t)b * M + gq;
    list[qq].write(idx + row * (K - drop), drop, K);
    if constexpr (kGather)
      list[qq].gather(dbb, C, drop, K, nbr + row * (K - drop) * C);
  }
}

template <int KP, bool kGather>
cudaError_t launch_kp(const float* q, const float* db, int B, int M, int N,
                      int C, int K, int drop, bool direct, int* idx,
                      float* nbr, cudaStream_t stream) {
  if (direct) {
    int split = 1;
    while (split < kKnnWarps && (long long)B * M * split < kFillWarps &&
           (N + 31) / 32 >= 4 * split)
      split *= 2;
    const int per_block = kKnnWarps / split;
    dim3 grid((M + per_block - 1) / per_block, B);
    knn_direct_kernel<KP, kGather><<<grid, kKnnThreads, 0, stream>>>(
        q, db, M, N, C, K, drop, split, idx, nbr);
  } else {
    const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(db) % 16 == 0;
    dim3 grid((M + kTQ - 1) / kTQ, B);
    knn_norm_kernel<KP, kGather><<<grid, kKnnThreads, 0, stream>>>(
        q, db, M, N, C, K, drop, vec, idx, nbr);
  }
  return cudaGetLastError();
}

template <bool kGather>
cudaError_t launch(const float* q, const float* db, int B, int M, int N,
                   int C, int K, int drop, bool direct, int* idx, float* nbr,
                   cudaStream_t stream) {
  switch ((K + 31) / 32) {
    case 1:
      return launch_kp<1, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                   nbr, stream);
    case 2:
      return launch_kp<2, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                   nbr, stream);
    case 3:
      return launch_kp<3, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                   nbr, stream);
    default:
      return launch_kp<4, kGather>(q, db, B, M, N, C, K, drop, direct, idx,
                                   nbr, stream);
  }
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
