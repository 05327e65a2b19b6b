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
//
// The bf16 instance (pdgn_edge_head_bwd_bf16: bf16 x, inte, pcat, ppoint
// and their cotangents, the backward of --compute_dtype bfloat16) keeps
// the design and takes every product on the core's bf16 instance, at the
// TPU kernel's rounding points (_head_bwd_kernel's _bf): the weights, x,
// the gathered rows and d_partial are bf16 operands; each window's dy
// (formed in fp32 from the upcasts, the stats cotangent folded in) is
// rounded to bf16 before it is summed into A_t, and S (the TPU kernel's
// d_point, the fp32 sum of the unrounded dy) is rounded once for its
// product and kept in fp32 for the bias gradient. A_t, the fp32 sum over a
// row's entries, is no rounding point of the TPU kernel, so it goes to the
// products as two bf16 parts, A_t = hi + lo to 2^-16 of |A_t|: Gc =
// [A_hi | S | A_lo] against W_conv = [Wn^T; conv_a^T; Wn^T], and d_wn =
// x^T A_hi + x^T A_lo (the caller adds the two blocks), 13 products of C
// x 4Fin a point each way at k = 10 instead of 7. The one rounding the
// gathered design moves is the TPU kernel's per-entry dnbr, which does not
// exist here. d_wrow is summed onto d_pcat after its bf16 rounding. d_x,
// d_pcat and d_ppoint are stored in bf16; the weight and bias gradients
// in fp32.
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

// bf16 dy of W adjacent columns: dy = d_inte + ds0 + 2 * inte * ds1 in
// fp32 from the upcasts, each operation rounded on its own (no
// contraction), as the plain version evaluates it
__device__ __forceinline__ float dy_rn(float di, float in, float s0,
                                       float s1) {
  return __fadd_rn(__fadd_rn(di, s0), __fmul_rn(__fmul_rn(2.f, in), s1));
}
template <int W>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float v[W]) {
  if constexpr (W == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(a);
    v[1] = __high2float(a);
    v[2] = __low2float(b);
    v[3] = __high2float(b);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int W>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p,
                                           const float v[W]) {
  if constexpr (W == 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) =
        __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) =
        __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// The bf16 instance's gather: Gc[q] = [hi(A_0) | .. | hi(A_{window-1}) |
// S | lo(A_0) | .. | lo(A_{window-1})] in bf16, blocks of ldf columns
// (pads 0), A_t the fp32 sum over the row's entries of the bf16-rounded dy
// (hi its rounding, lo the rounding of the rest), S the fp32 sum of the
// unrounded dy over the row's own windows, rounded once (and written in
// fp32 to sf, rows of 4Fin); dxm as cot_gather_kernel's. W = 4 columns a
// thread when four_fin % 4 == 0 (8-byte rows), else 1.
template <int W>
__global__ void cot_gather_bf16_kernel(
    const __nv_bfloat16* __restrict__ inte,
    const __nv_bfloat16* __restrict__ d_inte, const float* __restrict__ ds,
    const float* __restrict__ dm, const int* __restrict__ offsets,
    const int* __restrict__ entries, int k, int four_fin, int ldf, int c4,
    __nv_bfloat16* __restrict__ gc, float* __restrict__ sf,
    float* __restrict__ dxm) {
  const long long q = blockIdx.x;
  const int hk = k / 2, window = hk + 1;
  const int a = offsets[q], z = offsets[q + 1];
  const int U = four_fin / W, UL = ldf / W;
  __nv_bfloat16* out = gc + (size_t)q * (2 * window + 1) * ldf;
  for (int u = threadIdx.x; u < UL; u += blockDim.x) {
    const int c0 = u * W;
    float acc[W];
    if (u >= U) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.f;
      for (int t = 0; t <= 2 * window; ++t)
        store_bf16<W>(out + t * ldf + c0, acc);
      continue;
    }
    float s0[W], s1[W], di[W], in[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      s0[i] = ds[c0 + i];
      s1[i] = ds[four_fin + c0 + i];
      acc[i] = 0.f;
    }
    for (int wp = 0; wp < hk; ++wp) {
      const size_t o = ((size_t)q * hk + wp) * four_fin + c0;
      load_bf16<W>(d_inte + o, di);
      load_bf16<W>(inte + o, in);
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] += dy_rn(di[i], in[i], s0[i], s1[i]);
    }
    store_bf16<W>(out + window * ldf + c0, acc);
#pragma unroll
    for (int i = 0; i < W; ++i) sf[(size_t)q * four_fin + c0 + i] = acc[i];
    for (int t = 0; t < window; ++t) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.f;
      for (int e = a; e < z; ++e) {
        const int ent = entries[e];
        const int p = ent / k;  // global row b*N + n
        const int j = ent - p * k;
        if (j >= t && j < t + hk) {
          const size_t op = ((size_t)p * hk + (j - t)) * four_fin + c0;
          load_bf16<W>(d_inte + op, di);
          load_bf16<W>(inte + op, in);
#pragma unroll
          for (int i = 0; i < W; ++i)
            acc[i] += round_as<__nv_bfloat16>(
                dy_rn(di[i], in[i], s0[i], s1[i]));
        }
      }
      store_bf16<W>(out + t * ldf + c0, acc);
#pragma unroll
      for (int i = 0; i < W; ++i)
        acc[i] -= round_as<__nv_bfloat16>(acc[i]);
      store_bf16<W>(out + (window + 1 + t) * ldf + c0, acc);
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
// itself for j = k; x fp32 or bf16 (then c4 % 8 == 0, so that a granule
// of 8 columns lies in one block j)
template <class T>
struct GatherXOf {
  const T* x;
  const int* nbr;
  int c4, k;
  __device__ __forceinline__ int src_row(int p, int i) const {
    const int j = i / c4;
    return j < k ? nbr[(size_t)p * k + j] : p;
  }
  __device__ __forceinline__ const T* ptr(int src, int i) const {
    return x + (size_t)src * c4 + i % c4;
  }
};
using GatherX = GatherXOf<float>;

// S's column c of row r: Gc[r, window*ldf + c]
struct GcS {
  const float* gc;
  int gw, off;
  __device__ __forceinline__ float load(long long r, int c) const {
    return gc[(size_t)r * gw + off + c];
  }
};

// slot s of the weight-net rows reads extraction index j(s) = (s%2)*hk + s/2;
// the inverse is s(j) = j < hk ? 2j : 2(j - hk) + 1. T: the storage type
// of the weight-net rows' cotangents, pcat and ppoint (read as fp32; the
// bf16 instance forms dwrow in fp32 from the upcasts, unrounded wrow)
template <class T>
__device__ __forceinline__ float dwrow_at(const T* dwfea, const T* dwxyz,
                                          const float* dws, const T* pcat,
                                          const T* ppoint, long long p,
                                          long long q, int s, int ch, int k) {
  const int col = s * 32 + ch;
  float base = ch < 16 ? to_f32(dwfea[(size_t)p * k * 16 + s * 16 + ch])
                       : to_f32(dwxyz[(size_t)p * k * 16 + s * 16 + ch - 16]);
  if constexpr (sizeof(T) == 2) {
    const float wrow = __fadd_rn(to_f32(pcat[(size_t)q * 32 + ch]),
                                 to_f32(ppoint[(size_t)p * 32 + ch]));
    return __fadd_rn(__fadd_rn(base, dws[col]),
                     __fmul_rn(__fmul_rn(2.f, wrow), dws[k * 32 + col]));
  } else {
    float wrow = pcat[(size_t)q * 32 + ch] + ppoint[(size_t)p * 32 + ch];
    return base + dws[col] + 2.f * wrow * dws[k * 32 + col];
  }
}

// d_pcat[q, ch] = sum over the entries (p, j) naming q of dwrow[p, s(j), ch]
// (bf16: of dwrow rounded to bf16, the TPU kernel's scatter operand; the
// sum stored rounded)
template <class T>
__global__ void dpcat_gather_kernel(const T* __restrict__ dwfea,
                                    const T* __restrict__ dwxyz,
                                    const float* __restrict__ dws,
                                    const T* __restrict__ pcat,
                                    const T* __restrict__ ppoint,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ entries, int rows,
                                    int k, T* __restrict__ dpcat) {
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
    v += round_as<T>(dwrow_at(dwfea, dwxyz, dws, pcat, ppoint, p, q, s, ch,
                              k));
  }
  store_as(dpcat + (size_t)q * 32 + ch, v);
}

// d_ppoint[p, ch] = sum over slots of dwrow[p, s, ch] (stored as T)
template <class T>
__global__ void dppoint_kernel(const T* __restrict__ dwfea,
                               const T* __restrict__ dwxyz,
                               const float* __restrict__ dws,
                               const T* __restrict__ pcat,
                               const T* __restrict__ ppoint,
                               const int* __restrict__ idx, int rows, int N,
                               int k, T* __restrict__ dppoint) {
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
  store_as(dppoint + (size_t)p * 32 + ch, v);
}

// the weight-net cotangents' two gathers (gated stages)
template <class T>
void launch_dwrow(const T* d_wfea, const T* d_wxyz, const float* d_wstats,
                  const T* pcat, const T* ppoint, const int* idx,
                  const int* offsets, const int* entries, int rows, int N,
                  int k, T* d_pcat, T* d_ppoint, cudaStream_t stream) {
  const long long total = (long long)rows * 32;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  dpcat_gather_kernel<T><<<blocks, 256, 0, stream>>>(
      d_wfea, d_wxyz, d_wstats, pcat, ppoint, offsets, entries, rows, k,
      d_pcat);
  dppoint_kernel<T><<<blocks, 256, 0, stream>>>(d_wfea, d_wxyz, d_wstats,
                                                pcat, ppoint, idx, rows, N, k,
                                                d_ppoint);
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
    launch_dwrow(d_wfea, d_wxyz, d_wstats, pcat, ppoint, idx, offsets,
                 entries, rows, N, k, d_pcat, d_ppoint, stream);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

// The bf16 instance. As pdgn_edge_head_bwd, with bf16 x (B,N,c8), inte,
// w_conv ((2*window+1)*ldf, c8) = [Wn_0^T; ..; Wn_{window-1}^T; conv_a^T;
// Wn_0^T; ..; Wn_{window-1}^T], w_merge (t8, (k+1)*c8), d_inte, pcat,
// ppoint, d_wfea, d_wxyz; c8, ldf and t8: C, 4Fin and 2F rounded up to 8
// (a bf16 granule); d_partial (B,N,2F) fp32 unpadded (its bias sums) and
// dpart_b (B,N,t8) its bf16 rounding, zero-padded (the product operand).
// Outputs d_x (B,N,c8), d_pcat, d_ppoint bf16; d_wconv (c8,
// (2*window+1)*ldf) = x^T [A_hi | S | A_lo] (d_wn the sum of its hi and lo
// blocks), d_wmerge ((k+1)*c8, t8), d_pb_point, d_pb_merge fp32. Scratch:
// gc (B*N, (2*window+1)*ldf) bf16, sf (B*N, 4Fin) fp32, dm, dxm,
// tn_scratch, count, cursor, offsets, entries as there.
int pdgn_edge_head_bwd_bf16(
    const __nv_bfloat16* x, const int* idx, const int* nbr,
    const __nv_bfloat16* inte, int B, int N, int c8, int k, int four_fin,
    int two_f, int ldf, int t8, const __nv_bfloat16* w_conv,
    const __nv_bfloat16* w_merge, const __nv_bfloat16* d_inte,
    const float* d_partial, const __nv_bfloat16* dpart_b,
    const float* d_stats, const __nv_bfloat16* pcat,
    const __nv_bfloat16* ppoint, const __nv_bfloat16* d_wfea,
    const __nv_bfloat16* d_wxyz, const float* d_wstats, __nv_bfloat16* d_x,
    float* d_wconv, float* d_wmerge, float* d_pb_point, float* d_pb_merge,
    __nv_bfloat16* d_pcat, __nv_bfloat16* d_ppoint, __nv_bfloat16* gc,
    float* sf, float* dm, float* dxm, float* tn_scratch, int* count,
    int* cursor, int* offsets, int* entries, cudaStream_t stream) {
  if (c8 % 8 || ldf % 8 || t8 % 8 || ldf < four_fin || t8 < two_f ||
      k < 2 || k % 2)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const int rows = B * N;
  const int hk = k / 2;
  const int window = hk + 1;
  const int gw = (2 * window + 1) * ldf;
  const int mc = (k + 1) * c8;

  // 1. the reverse adjacency of the graph
  cudaError_t err = reverse_adjacency(idx, B, N, k, N, count, cursor, offsets,
                                      entries, stream);
  if (err != cudaSuccess) return (int)err;

  // 2. the merge's cotangents of every neighbour block
  err = tc_gemm<false, kGFold>(RowsBf16{dpart_b, t8}, w_merge, mc, rows, mc,
                               t8, t8, StorePairs{dm, mc}, stream);
  if (err != cudaSuccess) return (int)err;

  // 3. the cotangents gathered onto their rows
  const int vec = four_fin % 4 ? 1 : 4;
  int threads = (ldf / vec > c8 ? ldf / vec : c8) + 31;
  threads = threads / 32 * 32;
  if (threads > 256) threads = 256;
  if (vec == 4)
    cot_gather_bf16_kernel<4><<<rows, threads, 0, stream>>>(
        inte, d_inte, d_stats, dm, offsets, entries, k, four_fin, ldf, c8, gc,
        sf, dxm);
  else
    cot_gather_bf16_kernel<1><<<rows, threads, 0, stream>>>(
        inte, d_inte, d_stats, dm, offsets, entries, k, four_fin, ldf, c8, gc,
        sf, dxm);
  PDGN_CHECK_LAUNCH();

  // 4. the input gradient, rounded to bf16 at the store
  err = tc_gemm<false, kGFold>(RowsBf16{gc, gw}, w_conv, c8, rows, c8, gw, gw,
                               AddStoreTo<bf16>{d_x, dxm, nullptr, c8, c8},
                               stream);
  if (err != cudaSuccess) return (int)err;

  // 5. the weight gradients on the transposed bf16 products
  err = tc_gemm_tn(RowsBf16{x, c8}, gc, gw, rows, c8, gw, tn_scratch, d_wconv,
                   stream);
  if (err != cudaSuccess) return (int)err;
  err = tc_gemm_tn(GatherXOf<bf16>{x, nbr, c8, k}, dpart_b, t8, rows, mc, t8,
                   tn_scratch, d_wmerge, stream);
  if (err != cudaSuccess) return (int)err;

  // 6. per-batch bias gradients from the fp32 S and d_partial
  chunk_colsum(PlainA{sf, four_fin}, (long long)rows, four_fin, N, d_pb_point,
               stream);
  PDGN_CHECK_LAUNCH();
  chunk_colsum(PlainA{d_partial, two_f}, (long long)rows, two_f, N,
               d_pb_merge, stream);
  PDGN_CHECK_LAUNCH();

  if (pcat != nullptr) {
    launch_dwrow(d_wfea, d_wxyz, d_wstats, pcat, ppoint, idx, offsets,
                 entries, rows, N, k, d_pcat, d_ppoint, stream);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

}  // extern "C"
