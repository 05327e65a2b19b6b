// Edge-conv stage head backward for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/edge_head.py::_head_bwd_kernel
// (launcher _head_bwd_pallas): the VJP of the head for a fixed kNN graph.
// With dy[p, wp] = d_inte + ds0 + 2*inte*ds1 per window (the BN sums'
// cotangent folded in) and the forward
//   inte[p, wp] = x[p] conv_a + pb + sum_{t<window} x[idx[p, wp+t]] Wn_t,
//   partial[p]  = x[p] a_merge + pb_merge + sum_{j<k} x[idx[p, j]] wen_j:
// the forward's identity x[idx] W = (x W)[idx] has a transpose: sum the
// cotangents onto each row q first, in 4Fin space,
//   A_t[q] = sum over the entries (p, j) naming q with t <= j < t + hk of
//            dy[p, j - t]                                   (t < window)
//   S[q]   = sum_wp dy[q, wp],
// into Gc = [A_0 | .. | A_{window-1} | S], then multiply once:
//   d_x        = Gc [Wn_0^T; ..; Wn_{window-1}^T; conv_a^T]
//                + dm[q, k] + sum over the entries (p, j) naming q of dm[p, j],
//                dm = d_partial [wen_0; ..; wen_{k-1}; a_merge]^T
//   d_[wn; conv_a]   = x^T Gc
//   d_[wen; a_merge] = [x[idx[., j]] | x]^T d_partial
//   d_pb_point[b] = sum over the cloud's rows of S; d_pb_merge[b] = sum of
//   d_partial; gated: dwrow = [d_wfea | d_wxyz] + dws0 + 2*wrow*dws1 per
//   slot, d_ppoint = sum over slots, d_pcat = dwrow gathered to idx.
// The merge gains nothing from gathering first: its k+1 blocks each go to
// another neighbour, and dm ((k+1)*C a row) is narrower than gathered 2F
// cotangents would be.
//
// What bounds it on the H100: operations. At stage 4, B=35 (N=1024,
// C=128, 4Fin=1024, 2F=512, k=10): window+1 = 7 products of C x 4Fin a
// point for the input gradient and 7 for the weight gradient (65.8 + 65.8
// GFLOP), k+1 of C x 2F each way for the merge (51.7 + 51.7), 235 GFLOP at
// 3xTF32's 495 / 3 TFLOP/s; multiplying gathered rows instead costs 35 + 35
// products of C x 4Fin a point.
//
// The design:
//   1. reverse_adjacency (common.cuh): a counting sort of idx; each row's
//      list in ascending entry order, so every sum over it is taken in the
//      same order on every run.
//   2. dm = d_partial @ [wen; a_merge]^T on the shared product core
//      (tf32x3_gemm.cuh, folded).
//   3. cot_gather_kernel: a block a row q, threads over 4Fin (float4 when
//      4Fin % 4 == 0): S, then each A_t over the row's list (dy formed on
//      the fly from inte, d_inte and ds; a cloud's dy stays in L2 while its
//      rows are gathered), written to Gc in blocks of ldf columns; and
//      dxm[q] = dm[q, k] + the list's dm[p, j].
//   4. d_x = dxm + Gc @ W_conv on the shared core (the addend in the
//      epilogue).
//   5. The weight gradients on its transposed variant: reductions over the
//      B*N rows in 4096-row splits whose partials column_reduce adds in a
//      fixed order (x^T Gc; the merge's A rows gathered in the loader).
//   6. Per-batch bias gradients are column sums in a fixed order; the
//      weight-net gradients gather over the same reverse adjacency.
// No float atomics anywhere: the gradients are deterministic.
#include "tf32x3_gemm.cuh"

namespace {

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// dy = d_inte + ds0 + 2 * inte * ds1
__device__ __forceinline__ float dyv(float di, float in, float s0, float s1) {
  return di + s0 + 2.f * in * s1;
}
__device__ __forceinline__ float4 dyv(float4 di, float4 in, float4 s0,
                                      float4 s1) {
  return make_float4(dyv(di.x, in.x, s0.x, s1.x), dyv(di.y, in.y, s0.y, s1.y),
                     dyv(di.z, in.z, s0.z, s1.z), dyv(di.w, in.w, s0.w, s1.w));
}
template <class V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Gc[q] = [A_0 | .. | A_{window-1} | S] in blocks of ldf columns (pads 0)
// and dxm[q] (c4 columns), one block a row q. V = float4 needs four_fin %
// 4 == 0 and 16-byte aligned inte, d_inte, ds (then ldf = four_fin).
template <class V>
__global__ void cot_gather_kernel(const float* __restrict__ inte,
                                  const float* __restrict__ d_inte,
                                  const float* __restrict__ ds,
                                  const float* __restrict__ dm,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ entries, int k,
                                  int four_fin, int ldf, int c4,
                                  float* __restrict__ gc,
                                  float* __restrict__ dxm) {
  constexpr int VW = sizeof(V) / sizeof(float);
  const long long q = blockIdx.x;
  const int hk = k / 2, window = hk + 1;
  const int a = offsets[q], z = offsets[q + 1];
  const int U = four_fin / VW, UL = ldf / VW;
  const V* di = reinterpret_cast<const V*>(d_inte);
  const V* in = reinterpret_cast<const V*>(inte);
  const V* d0 = reinterpret_cast<const V*>(ds);
  const V* d1 = reinterpret_cast<const V*>(ds + four_fin);
  V* out = reinterpret_cast<V*>(gc + (size_t)q * (window + 1) * ldf);
  for (int u = threadIdx.x; u < UL; u += blockDim.x) {
    if (u >= U) {
      for (int t = 0; t <= window; ++t) out[t * UL + u] = vzero<V>();
      continue;
    }
    const V s0 = d0[u], s1 = d1[u];
    size_t o = (size_t)q * hk * U + u;
    V s = dyv(di[o], in[o], s0, s1);
    for (int wp = 1; wp < hk; ++wp) {
      o += U;
      s = vadd(s, dyv(di[o], in[o], s0, s1));
    }
    out[window * UL + u] = s;
    for (int t = 0; t < window; ++t) {
      V acc = vzero<V>();
      for (int e = a; e < z; ++e) {
        const int ent = entries[e];
        const int p = ent / k;  // global row b*N + n
        const int j = ent - p * k;
        if (j >= t && j < t + hk) {
          const size_t op = ((size_t)p * hk + (j - t)) * U + u;
          acc = vadd(acc, dyv(di[op], in[op], s0, s1));
        }
      }
      out[t * UL + u] = acc;
    }
  }
  const size_t mc = (size_t)(k + 1) * c4;
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    float v = dm[(size_t)q * mc + (size_t)k * c4 + c];
    for (int e = a; e < z; ++e) {
      const int ent = entries[e];
      const int p = ent / k;
      const int j = ent - p * k;
      v += dm[(size_t)p * mc + (size_t)j * c4 + c];
    }
    dxm[(size_t)q * c4 + c] = v;
  }
}

// The merge's A rows, reduction-major: row p, column i = j*c4 + c reads
// x[nbr[p, j]] for j < k (nbr: the graph's global rows b*N + idx), x[p]
// itself for j = k
struct GatherX {
  const float* x;
  const int* nbr;
  int c4, k;
  __device__ __forceinline__ int src_row(int p, int i) const {
    const int j = i / c4;
    return j < k ? nbr[(size_t)p * k + j] : p;
  }
  __device__ __forceinline__ const float* ptr(int src, int i) const {
    return x + (size_t)src * c4 + i % c4;
  }
};

// S's column c of row r: Gc[r, window*ldf + c]
struct GcS {
  const float* gc;
  int gw, off;
  __device__ __forceinline__ float load(long long r, int c) const {
    return gc[(size_t)r * gw + off + c];
  }
};

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

// Forward operands: x (B,N,c4) zero-padded to c4 % 4 == 0 columns, idx
// (B,N,k) int32 and nbr = idx + b*N (the global rows), inte (B,N,hk*4Fin); w_conv ((window+1)*ldf, c4) =
// [Wn_0^T; ..; Wn_{window-1}^T; conv_a^T] and w_merge (t4, (k+1)*c4) =
// [wen; a_merge]^T, zero-padded blocks (ldf = 4Fin and t4 = 2F rounded up
// to 4). Cotangents: d_inte like inte, d_partial (B,N,t4) zero-padded,
// d_stats (2,4Fin); gated (pcat non-null) also d_wfea, d_wxyz (B,N,k*16),
// d_wstats (2,k*32) and pcat, ppoint (B,N,32). x, w_*, d_partial, gc and,
// when 4Fin % 4 == 0, inte, d_inte and d_stats 16-byte aligned.
// Outputs: d_x (B,N,c4), d_wconv (c4, (window+1)*ldf), d_wmerge
// ((k+1)*c4, t4), d_pb_point (B,4Fin), d_pb_merge (B,2F); gated d_pcat,
// d_ppoint (B,N,32). Scratch: gc (B*N, (window+1)*ldf), dm (B*N,
// (k+1)*c4), dxm (B*N, c4), tn_scratch (the larger of the two weight
// products' split partials), count/cursor (B*N ints), offsets (B*N+1),
// entries (B*N*k).
int pdgn_edge_head_bwd(
    const float* x, const int* idx, const int* nbr, const float* inte, int B,
    int N, int c4,
    int k, int four_fin, int two_f, int ldf, int t4, const float* w_conv,
    const float* w_merge, const float* d_inte, const float* d_partial,
    const float* d_stats, const float* pcat, const float* ppoint,
    const float* d_wfea, const float* d_wxyz, const float* d_wstats,
    float* d_x, float* d_wconv, float* d_wmerge, float* d_pb_point,
    float* d_pb_merge, float* d_pcat, float* d_ppoint, float* gc, float* dm,
    float* dxm, float* tn_scratch, int* count, int* cursor, int* offsets,
    int* entries, cudaStream_t stream) {
  if (c4 % 4 || ldf % 4 || t4 % 4 || ldf < four_fin || t4 < two_f ||
      k < 2 || k % 2)
    return (int)cudaErrorInvalidValue;
  const int rows = B * N;
  const int hk = k / 2;
  const int window = hk + 1;
  const int gw = (window + 1) * ldf;
  const int mc = (k + 1) * c4;

  // 1. the reverse adjacency of the graph
  cudaError_t err = reverse_adjacency(idx, B, N, k, N, count, cursor, offsets,
                                      entries, stream);
  if (err != cudaSuccess) return (int)err;

  // 2. the merge's cotangents of every neighbour block
  err = tc_gemm<false, kGFold>(RowsA{d_partial, t4}, w_merge, mc, rows, mc,
                               t4, t4, StorePairs{dm, mc}, stream);
  if (err != cudaSuccess) return (int)err;

  // 3. the cotangents gathered onto their rows
  const int width = four_fin % 4 ? ldf : ldf / 4;
  int threads = (width > c4 ? width : c4) + 31;
  threads = threads / 32 * 32;
  if (threads > 256) threads = 256;
  if (four_fin % 4 == 0)
    cot_gather_kernel<float4><<<rows, threads, 0, stream>>>(
        inte, d_inte, d_stats, dm, offsets, entries, k, four_fin, ldf, c4, gc,
        dxm);
  else
    cot_gather_kernel<float><<<rows, threads, 0, stream>>>(
        inte, d_inte, d_stats, dm, offsets, entries, k, four_fin, ldf, c4, gc,
        dxm);
  PDGN_CHECK_LAUNCH();

  // 4. the input gradient: 7 products of C x 4Fin a point
  err = tc_gemm<false, kGFold>(RowsA{gc, gw}, w_conv, c4, rows, c4, gw, gw,
                               AddStore{d_x, dxm, nullptr, c4, c4}, stream);
  if (err != cudaSuccess) return (int)err;

  // 5. the weight gradients, rows reduced in split blocks
  err = tc_gemm_tn(RowsA{x, c4}, gc, gw, rows, c4, gw, tn_scratch, d_wconv,
                   stream);
  if (err != cudaSuccess) return (int)err;
  err = tc_gemm_tn(GatherX{x, nbr, c4, k}, d_partial, t4, rows, mc, t4,
                   tn_scratch, d_wmerge, stream);
  if (err != cudaSuccess) return (int)err;

  // 6. per-batch bias gradients
  chunk_colsum(GcS{gc, gw, window * ldf}, (long long)rows, four_fin, N,
               d_pb_point, stream);
  PDGN_CHECK_LAUNCH();
  chunk_colsum(PlainA{d_partial, t4}, (long long)rows, two_f, N, d_pb_merge,
               stream);
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
