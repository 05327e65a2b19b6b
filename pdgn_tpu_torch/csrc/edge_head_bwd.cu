// Edge-conv stage head backward for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/edge_head.py::_head_bwd_kernel
// (launcher _head_bwd_pallas): the VJP of the head for a fixed kNN graph.
// With dy = d_inte + ds0 + 2*inte*ds1 per window (the BN sums' cotangent
// folded in) and the forward's operands x, idx, [wn; conv_a], [wen; a_merge]:
//   d_x       = centre terms (sum_wp dy) conv_a^T + d_partial a_merge^T
//               + the neighbour cotangents scattered to idx
//               (d_partial wen_j^T + sum of the windows covering slot j of
//               dy wn^T);
//   d_[wn; conv_a]   = sum over rows (b, n, wp) of patch^T dy;
//   d_[wen; a_merge] = sum over rows (b, n) of [nbr | x]^T d_partial;
//   d_pb_point[b] = sum_n sum_wp dy; d_pb_merge[b] = sum_n d_partial;
//   gated: dwrow = [d_wfea | d_wxyz] + dws0 + 2*wrow*dws1 per slot,
//          d_ppoint = sum over slots, d_pcat = dwrow scattered to idx.
//
// What bounds it on the H100: operations. At stage 4 (N=1024, C=128,
// 4Fin=1024, 2F=512, k=10) one cloud costs 2 x 8.3 GFLOP for the window
// conv's input and weight gradients and 2 x 1.5 GFLOP for the merge's, about
// twice the forward, against ~100 MB of traffic.
//
// The simple design, plain launches over the forward's SIMT GEMM template:
//   1. dp = dy @ [wn; conv_a]^T (dy formed in the A loader, never stored):
//      per (row, window) the patch cotangents and, in the last C columns,
//      the centre term. dm = d_partial @ [wen; a_merge]^T likewise.
//   2. The weight gradients are transposed GEMMs whose reduction runs over
//      the B*N*k/2 (conv) or B*N (merge) rows, with the forward's gathered
//      A loader: split into 4096-row blocks, partials added in a fixed order.
//   3. The scatter to the neighbours is a gather: the reverse adjacency of
//      idx (common.cuh; counting sort, each list in ascending order) lets one
//      block per point add the cotangents of every (row, slot) that names it,
//      always in the same order. No float atomics: the gradient is
//      deterministic.
//   4. Per-batch bias gradients are column sums in a fixed order.
#include "common.cuh"

namespace {

// dy(row, col) over rows (b, n, wp) of width 4Fin
struct DyLoad {
  const float* inte;
  const float* dinte;
  const float* ds;  // (2, 4Fin)
  int four_fin;
  __device__ __forceinline__ float load(long long row, int col) const {
    size_t o = (size_t)row * four_fin + col;
    return dinte[o] + ds[col] + 2.f * inte[o] * ds[four_fin + col];
  }
};

// The forward's gathered A operand: row (p, r), slot s < S reads the
// neighbour idx[p, r + s] of sample p / N, the last slot x[p] itself.
struct GatherRows {
  const float* x;
  const int* idx;
  int N, C, k, R, S;
  __device__ __forceinline__ float load(long long row, int kk) const {
    int s = kk / C, c = kk - s * C;
    long long p = row / R;
    int r = (int)(row - p * R);
    long long src;
    if (s < S) {
      long long b = p / N;
      src = b * N + idx[(size_t)p * k + r + s];
    } else {
      src = p;
    }
    return x[(size_t)src * C + c];
  }
};

// d_x[q, c] = centre terms + the neighbour cotangents of every entry
// (p, j) with idx[p, j] == q. dp: (rows*hk, (window+1)*C); dm: (rows, (k+1)*C).
__global__ void dx_gather_kernel(const float* __restrict__ dp,
                                 const float* __restrict__ dm,
                                 const int* __restrict__ offsets,
                                 const int* __restrict__ entries, int C, int k,
                                 int hk, int window, float* __restrict__ dx) {
  const long long q = blockIdx.x;
  const int wc = (window + 1) * C;
  const int mc = (k + 1) * C;
  const int a = offsets[q], z = offsets[q + 1];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = dm[(size_t)q * mc + k * C + c];
    for (int wp = 0; wp < hk; ++wp)
      v += dp[((size_t)q * hk + wp) * wc + window * C + c];
    for (int e = a; e < z; ++e) {
      const long long ent = entries[e];
      const long long p = ent / k;  // global row b*N + n
      const int j = (int)(ent - p * k);
      float u = dm[(size_t)p * mc + j * C + c];
      const int lo = j - window + 1 > 0 ? j - window + 1 : 0;
      const int hi = j < hk - 1 ? j : hk - 1;
      for (int wp = lo; wp <= hi; ++wp)
        u += dp[((size_t)p * hk + wp) * wc + (j - wp) * C + c];
      v += u;
    }
    dx[(size_t)q * C + c] = v;
  }
}

// slot s of the weight-net rows reads extraction index j(s) = (s%2)*hk + s/2;
// the inverse is s(j) = j < hk ? 2j : 2(j - hk) + 1
__device__ __forceinline__ float dwrow_at(const float* dwfea, const float* dwxyz,
                                          const float* dws, const float* pcat,
                                          const float* ppoint, long long p,
                                          long long q, int s, int ch, int k) {
  const int col = s * 32 + ch;
  float base = ch < 16 ? dwfea[(size_t)p * k * 16 + s * 16 + ch]
                       : dwxyz[(size_t)p * k * 16 + s * 16 + ch - 16];
  float wrow = pcat[(size_t)q * 32 + ch] + ppoint[(size_t)p * 32 + ch];
  return base + dws[col] + 2.f * wrow * dws[k * 32 + col];
}

// d_pcat[q, ch] = sum over the entries (p, j) naming q of dwrow[p, s(j), ch]
__global__ void dpcat_gather_kernel(const float* __restrict__ dwfea,
                                    const float* __restrict__ dwxyz,
                                    const float* __restrict__ dws,
                                    const float* __restrict__ pcat,
                                    const float* __restrict__ ppoint,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ entries, int rows,
                                    int k, float* __restrict__ dpcat) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * 32) return;
  const long long q = t / 32;
  const int ch = (int)(t % 32);
  const int hk = k / 2;
  float v = 0.f;
  for (int e = offsets[q]; e < offsets[q + 1]; ++e) {
    const long long ent = entries[e];
    const long long p = ent / k;
    const int j = (int)(ent - p * k);
    const int s = j < hk ? 2 * j : 2 * (j - hk) + 1;
    v += dwrow_at(dwfea, dwxyz, dws, pcat, ppoint, p, q, s, ch, k);
  }
  dpcat[(size_t)q * 32 + ch] = v;
}

// d_ppoint[p, ch] = sum over slots of dwrow[p, s, ch]
__global__ void dppoint_kernel(const float* __restrict__ dwfea,
                               const float* __restrict__ dwxyz,
                               const float* __restrict__ dws,
                               const float* __restrict__ pcat,
                               const float* __restrict__ ppoint,
                               const int* __restrict__ idx, int rows, int N,
                               int k, float* __restrict__ dppoint) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * 32) return;
  const long long p = t / 32;
  const int ch = (int)(t % 32);
  const int hk = k / 2;
  const long long b = p / N;
  float v = 0.f;
  for (int s = 0; s < k; ++s) {
    const int j = (s % 2) * hk + s / 2;
    const long long q = b * N + idx[(size_t)p * k + j];
    v += dwrow_at(dwfea, dwxyz, dws, pcat, ppoint, p, q, s, ch, k);
  }
  dppoint[(size_t)p * 32 + ch] = v;
}

}  // namespace

extern "C" {

// Forward operands: x (B,N,C), idx (B,N,k) int32, inte (B,N,hk*4Fin);
// w_conv_t (4Fin, (window+1)*C) = [wn_flat; conv_a]^T, w_merge_t
// (2F, (k+1)*C) = [wen; a_merge]^T. Cotangents: d_inte like inte, d_partial
// (B,N,2F), d_stats (2,4Fin); gated (pcat non-null) also d_wfea, d_wxyz
// (B,N,k*16), d_wstats (2,k*32) and pcat, ppoint (B,N,32).
// Outputs: d_x (B,N,C), d_wconv ((window+1)*C, 4Fin), d_wmerge
// ((k+1)*C, 2F), d_pb_point (B,4Fin), d_pb_merge (B,2F); gated d_pcat,
// d_ppoint (B,N,32). Scratch: dp (B*N*hk, (window+1)*C), dm (B*N, (k+1)*C),
// tn_scratch (max of the two weight GEMMs' split partials), count/cursor
// (B*N ints), offsets (B*N+1), entries (B*N*k).
int pdgn_edge_head_bwd(
    const float* x, const int* idx, const float* inte, int B, int N, int C,
    int k, int four_fin, int two_f, const float* w_conv_t,
    const float* w_merge_t, const float* d_inte, const float* d_partial,
    const float* d_stats, const float* pcat, const float* ppoint,
    const float* d_wfea, const float* d_wxyz, const float* d_wstats,
    float* d_x, float* d_wconv, float* d_wmerge, float* d_pb_point,
    float* d_pb_merge, float* d_pcat, float* d_ppoint, float* dp, float* dm,
    float* tn_scratch, int* count, int* cursor, int* offsets, int* entries,
    cudaStream_t stream) {
  const int rows = B * N;
  const int hk = k / 2;
  const int window = hk + 1;
  const long long rows_conv = (long long)rows * hk;
  const int wc = (window + 1) * C;
  const int mc = (k + 1) * C;

  DyLoad dy{inte, d_inte, d_stats, four_fin};
  PlainA dpart{d_partial, two_f};

  // 1. input-side products (no bias, no addend)
  gemm(dy, w_conv_t, (int)rows_conv, four_fin, wc,
       Epilogue{dp, nullptr, nullptr, wc}, stream);
  PDGN_CHECK_LAUNCH();
  gemm(dpart, w_merge_t, rows, two_f, mc, Epilogue{dm, nullptr, nullptr, mc},
       stream);
  PDGN_CHECK_LAUNCH();

  // 2. weight gradients, rows reduced in split blocks
  GatherRows a_conv{x, idx, N, C, k, hk, window};
  gemm_tn(a_conv, dy, rows_conv, wc, four_fin, tn_scratch, d_wconv, stream);
  PDGN_CHECK_LAUNCH();
  GatherRows a_merge{x, idx, N, C, k, 1, k};
  gemm_tn(a_merge, dpart, (long long)rows, mc, two_f, tn_scratch, d_wmerge,
          stream);
  PDGN_CHECK_LAUNCH();

  // 3. the neighbour scatter as a gather over the reverse adjacency
  cudaError_t err = reverse_adjacency(idx, B, N, k, N, count, cursor, offsets,
                                      entries, stream);
  if (err != cudaSuccess) return (int)err;
  const int tpb = C >= 128 ? 128 : (C >= 64 ? 64 : 32);
  dx_gather_kernel<<<rows, tpb, 0, stream>>>(dp, dm, offsets, entries, C, k,
                                             hk, window, d_x);
  PDGN_CHECK_LAUNCH();

  // 4. per-batch bias gradients
  chunk_colsum(dy, rows_conv, four_fin, N * hk, d_pb_point, stream);
  PDGN_CHECK_LAUNCH();
  chunk_colsum(dpart, (long long)rows, two_f, N, d_pb_merge, stream);
  PDGN_CHECK_LAUNCH();

  if (pcat != nullptr) {
    const long long total = (long long)rows * 32;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    dpcat_gather_kernel<<<blocks, 256, 0, stream>>>(
        d_wfea, d_wxyz, d_wstats, pcat, ppoint, offsets, entries, rows, k,
        d_pcat);
    PDGN_CHECK_LAUNCH();
    dppoint_kernel<<<blocks, 256, 0, stream>>>(d_wfea, d_wxyz, d_wstats, pcat,
                                               ppoint, idx, rows, N, k,
                                               d_ppoint);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

}  // extern "C"
