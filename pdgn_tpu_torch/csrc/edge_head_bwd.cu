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
// the TPU kernel's rounding points (_head_bwd_kernel's _bf): the weights,
// x, the gathered rows and d_partial are bf16 operands; each window's dy
// (formed in fp32 from the upcasts, the stats cotangent folded in, each
// operation rounded on its own) is rounded to bf16 once, dy_b, and S (the
// TPU kernel's d_point, the fp32 sum of the unrounded dy) is rounded once
// for its products and kept in fp32 for the bias gradient. A_t, the fp32
// sum over a row's entries of dy_b, is no rounding point of the TPU
// kernel, so d_x takes it as two bf16 parts, A_t = hi + lo to 2^-16 of
// |A_t|: d_x = dxm + [A_hi | S_b | A_lo] [Wn^T; conv_a^T; Wn^T], rounded to
// bf16 once. The weight gradients take the TPU kernel's own form, which
// needs neither A_t nor its split: d_wn[t] = sum over (p, wp) of
// x[nbr[p, wp + t]]^T dy_b[p, wp] (its patch^T dy_b), d_conv_a = x^T S_b,
// d_[wen; a_merge] = [x[nbr] | x]^T dpart_b. d_wrow is summed onto d_pcat
// after its bf16 rounding. d_x, d_pcat and d_ppoint are stored in bf16; the
// weight and bias gradients in fp32.
//
// What bounds the bf16 instance on the H100, at stage 4, B=35 (rows =
// 35,840, C=128, 4Fin=1024, 2F=512, k=10): the products, 122 GFLOP for d_x
// (13 blocks of C x 4Fin a point), 282 for d_wn (hk * window of them), 2 x
// 51.7 for the merge and 9.4 for d_conv_a at the bf16 tensor cores' 989
// TFLOP/s, and the gather of dy_b, 30 rows of 4Fin a row (2.2 GB) through
// L2. Its launches:
//   1. reverse_adjacency, as above;
//   2. dm = dpart_b [wen; a_merge]^T on hopper.cuh's product_bf16_kernel
//      (K-major);
//   3. dy_pass_bf16_kernel, a few rows a block: dy_b (rows, hk, ld8) and
//      S_b (sb) from the rows' own windows, S's fp32 partial sums for the
//      bias gradient; the rows' gathered x blocks xg[q] = [x[nbr[q, 0]] |
//      .. | x[nbr[q, k-1]] | x[q]] (the weight gradients' A operand, one
//      TMA map for every tap); dxm as cot_gather_kernel makes it;
//   4. dx_bf16_kernel (below): d_x in one launch whose producer warps sum
//      the gathered dy_b rows straight into the product's A slabs, so that
//      Gc is never written;
//   5. the weight gradients on product_bf16_kernel (MN-major, the rows in
//      contiguous splits whose partials column_reduce adds in a fixed
//      order);
//   6. the bias sums and the weight-net gathers, as above.
#include "hopper.cuh"
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

// ---------------------------------------------------- the bf16 instance
// dy = d_inte + ds0 + 2 * inte * ds1 in fp32 from the upcasts, each
// operation rounded on its own (no contraction), as the plain version
// evaluates it
__device__ __forceinline__ float dy_rn(float di, float in, float s0,
                                       float s1) {
  return __fadd_rn(__fadd_rn(di, s0), __fmul_rn(__fmul_rn(2.f, in), s1));
}

// 8 bf16 as fp32, and 8 fp32 stored rounded to bf16: one 16-byte access
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// columns c0 .. c0 + 7 of a bf16 row as fp32, 0 at and past n (W = 8: the
// row 16-byte aligned and n a multiple of 8, one load)
template <int W>
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c0, int n,
                                      float (&v)[8]) {
  if constexpr (W == 8) {
    unpack8(*reinterpret_cast<const uint4*>(row + c0), v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = c0 + i < n ? __bfloat162float(row[c0 + i]) : 0.f;
  }
}

// dy_pass_bf16_kernel, a block rpb rows of one cloud (kDyThreads threads
// over the rows' granules of 8 columns, ld8 / 8 a row): dy of the row's hk
// windows, rounded to bf16 into dyb (rows, hk, ld8), and S, their fp32 sum
// in window order, rounded into sb (rows, ld8), pads 0; spart (rows /
// rpb, four_fin), the block's rows' S summed in row order (the bias
// gradient's partial, through shared memory: rpb * ld8 floats); xg[q] =
// [x[nbr[q, 0]] | .. | x[nbr[q, k-1]] | x[q]] (rows, k+1, c8); dxm[q] =
// dm[q, k] + the row's list's dm[p, j] (c8 columns, as cot_gather_kernel);
// the list's entries (p, j) decoded for the d_x kernel, dec[e] = {p * hk +
// j, j}. W = 8 when four_fin % 8 == 0 (16-byte rows of inte and d_inte),
// else 1.
constexpr int kDyThreads = 256;

template <int W>
__global__ void __launch_bounds__(kDyThreads)
dy_pass_bf16_kernel(
    const __nv_bfloat16* __restrict__ inte,
    const __nv_bfloat16* __restrict__ d_inte, const float* __restrict__ ds,
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
    const float* __restrict__ dm, const int* __restrict__ offsets,
    const int* __restrict__ entries, int k, int four_fin, int ld8, int c8,
    int rpb, __nv_bfloat16* __restrict__ dyb, float* __restrict__ spart,
    __nv_bfloat16* __restrict__ sb, __nv_bfloat16* __restrict__ xg,
    float* __restrict__ dxm, int2* __restrict__ dec) {
  extern __shared__ float s_rows[];  // the block's rows' S, (rpb, ld8)
  const long long q0 = (long long)blockIdx.x * rpb;
  const int hk = k / 2, g8 = ld8 / 8;
  for (int task = threadIdx.x; task < rpb * g8; task += blockDim.x) {
    const int r = task / g8, c0 = 8 * (task - r * g8);
    const long long q = q0 + r;
    float s0[8], s1[8], S[8], di[8], in[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = c0 + i < four_fin;
      s0[i] = ok ? ds[c0 + i] : 0.f;
      s1[i] = ok ? ds[four_fin + c0 + i] : 0.f;
    }
    for (int wp = 0; wp < hk; ++wp) {
      const size_t o = ((size_t)q * hk + wp) * four_fin;
      load8<W>(d_inte + o, c0, four_fin, di);
      load8<W>(inte + o, c0, four_fin, in);
      float dy[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dy[i] = dy_rn(di[i], in[i], s0[i], s1[i]);
        S[i] = wp ? S[i] + dy[i] : dy[i];
      }
      *reinterpret_cast<uint4*>(dyb + ((size_t)q * hk + wp) * ld8 + c0) =
          pack8(dy);
    }
    *reinterpret_cast<uint4*>(sb + (size_t)q * ld8 + c0) = pack8(S);
#pragma unroll
    for (int i = 0; i < 8; ++i) s_rows[r * ld8 + c0 + i] = S[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < four_fin; c += blockDim.x) {
    float v = s_rows[c];
    for (int r = 1; r < rpb; ++r) v += s_rows[r * ld8 + c];
    spart[(size_t)blockIdx.x * four_fin + c] = v;
  }
  const int c8g = c8 / 8;
  for (int task = threadIdx.x; task < rpb * (k + 1) * c8g;
       task += blockDim.x) {
    const int r = task / ((k + 1) * c8g), rest = task - r * (k + 1) * c8g;
    const int j = rest / c8g, c = 8 * (rest - j * c8g);
    const long long q = q0 + r;
    const long long src = j < k ? nbr[(size_t)q * k + j] : q;
    *reinterpret_cast<uint4*>(xg + ((size_t)q * (k + 1) + j) * c8 + c) =
        *reinterpret_cast<const uint4*>(x + (size_t)src * c8 + c);
  }
  const int ea = offsets[q0], eb = offsets[q0 + rpb];
  for (int e = ea + threadIdx.x; e < eb; e += blockDim.x) {
    const int ent = entries[e];
    const int p = ent / k;
    const int j = ent - p * k;
    dec[e] = make_int2(p * hk + j, j);
  }
  const size_t mc = (size_t)(k + 1) * c8;
  for (int task = threadIdx.x; task < rpb * c8; task += blockDim.x) {
    const int r = task / c8, c = task - r * c8;
    const long long q = q0 + r;
    float v = dm[(size_t)q * mc + (size_t)k * c8 + c];
    for (int e = offsets[q]; e < offsets[q + 1]; ++e) {
      const int ent = entries[e];
      const int p = ent / k;
      const int j = ent - p * k;
      v += dm[(size_t)p * mc + (size_t)j * c8 + c];
    }
    dxm[(size_t)q * c8 + c] = v;
  }
}

// dx_bf16_kernel<NT>: d_x = dxm + [A_hi | S_b | A_lo] W_dx, rounded to bf16
// once, Gc never written. Persistent; a block is one consumer warpgroup
// and kXPW producer warps (12, 512 threads, where the consumer's NT / 2
// accumulators fit 128 registers a thread; else 8). A work item is a
// 64-row tile and NT columns of C, taken from a counter (a tile whose rows
// have long lists takes longer; the blocks that finish first take the
// next). Its depth runs in stages of 128 columns of 4Fin, window t outer:
// stage (t, ch) of a window t < window holds A_hi and A_lo of columns
// ch*128 .. +127 (two 64-column slabs each, 64 rows of 128 bytes in the
// 128-byte swizzle) and the two matching boxes of W_dx (row c of w_dx
// holds Wn_t[c, f] at column t*ldk + f, conv_a[c, f] at window*ldk + f):
// both A parts meet the same W slab. The last window's stages hold S_b, by
// TMA, instead.
//   - the producers: a row's A_t is the fp32 sum over its reverse-adjacency
//     list (ascending entries) of dy_b[p, j - t] for the entries (p, j)
//     with t <= j < t + hk. At the start of each window they list the
//     tile's hits in shared memory (a warp a row: ballots over 32 entries
//     of the decoded list dec, counts, one warp's scan, then the dy_b rows
//     in place), so that a stage walks hits only. kNN graphs have hub rows
//     named by many (in the stage-4 check graph one of 64 rows has a list
//     of 91 on average, the longest 293), so the hits are cut between the
//     warps by count, not by row: warp w walks hits [H w / kXPW, H (w + 1)
//     / kXPW) as one stream, kXBatch 8-byte loads of dy_b in flight a lane
//     (4 columns), and sums them row by row. A row whose hits lie inside
//     the warp's part is written at once (hi = bf16(A_t), lo = bf16(A_t -
//     hi)); a row that runs on into the next warps is finished by the warp
//     it starts in, which adds their parts (spilled to shared memory) in
//     warp order after a barrier of the producers: the same order every
//     run. A tile whose window has more hits than the list holds walks the
//     decoded reverse adjacency itself the same way. Each thread fences its
//     stores into the async proxy and each warp's lane 0 arrives on the
//     stage's full barrier. Thread 0 takes the items, writes each stage's
//     item into its header and loads the stage's W boxes (and S_b's) by
//     TMA.
//   - the consumer warpgroup: wgmma m64nNTk16 on each stage's four (S:
//     two) slabs, the accumulators in registers over the item's
//     (window + 1) * nc stages; the epilogue adds dxm and rounds once.
// Tried on the H100 and not kept, in order (d_x alone, stage 4, B=35, the
// kernel's own profile in development runs): each warp its 8 of the tile's
// rows two at a time, walking whole lists, 8.18 ms (hub rows: one warp's
// rows held every stage); the entries cut by count
// between 16-lane groups, 4.14; warps as groups over decoded entries,
// 3.55; a warp per row segment, 3.84; the hit lists, 2.70; 16-lane
// groups over them, 3.96 (the two halves' rows diverge and their loads
// wait for each other); one stream across row ends, 2.16; 16 producer
// warps, 2.03 (spills); 32 loads in flight a lane, 2.28.
constexpr int kXM = 64;                       // rows an item
constexpr int kXK = 128;                      // depth a stage: 2 slabs
constexpr int kXSlab = kXM * 64 * 2;          // 8 KB
constexpr int kXABytes = 4 * kXSlab;          // A_hi, A_lo: 32 KB a stage
constexpr int kXConsumers = 128;
constexpr int kXBatch = 16;                   // loads a lane has in flight
constexpr int kXSmemMax = 232448;             // the H100's dynamic limit
constexpr int kXBarBytes = 256;               // barriers, headers, items
// producer warps: three warpgroups where the consumer's NT / 2
// accumulators fit the 128 registers a thread of 512, else two
template <int NT>
constexpr int kXPW = NT <= 128 ? 12 : 8;
template <int NT>
constexpr int kXThreads = kXConsumers + 32 * kXPW<NT>;
template <int NT>
constexpr int kXSpill = 2 * kXPW<NT> * 32 * 16;  // two buffers of parts
template <int NT>
constexpr int kXStage = kXABytes + NT * kXK * 2;  // A and W_dx a stage
constexpr int kXRowBytes = 2 * 72 * 4;      // a window's row counts, starts
template <int NT>
constexpr int kXFree =
    kXSmemMax - 1024 - kXBarBytes - kXSpill<NT> - kXRowBytes;
template <int NT>
constexpr int kXStages =
    kXFree<NT> / kXStage<NT> < 4 ? kXFree<NT> / kXStage<NT> : 4;
// a window's hit list: what shared memory holds beside the ring
template <int NT>
constexpr int kXCap = (kXFree<NT> - kXStages<NT> * kXStage<NT>) / 4;
template <int NT>
constexpr int kXSmemBytes = 1024 + kXStages<NT> * kXStage<NT> +
                            kXSpill<NT> + kXRowBytes + kXBarBytes +
                            4 * kXCap<NT>;

struct DxArgs {
  const __nv_bfloat16* dyb;  // (rows, hk, ld8)
  const float* dxm;          // (rows, c8)
  const int* offsets;        // the reverse adjacency
  const int2* dec;           // its entries (p, j) as {p * hk + j, j}
  __nv_bfloat16* d_x;        // (rows, c8)
  int* counter;              // items taken: 0 at the launch
  int rows, k, ld8, c8;
  int nc;                    // stages a window: ceil(four_fin / kXK)
  int ct;                    // column tiles of NT
  int items;                 // row tiles * ct
};

// the first row r in [lo, hi) with bnd[r] >= e (hi if none)
__device__ __forceinline__ int first_row_at(const int* bnd, int lo, int hi,
                                            int e) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bnd[mid] >= e)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// A producer warp's share of a window of an item's tile, over a list
// whose row r (of the tile's nr) spans [bnd[r], bnd[r + 1]): the
// window's hit list, or the tile's slice of the reverse adjacency. The
// list is cut into `groups` equal parts; the warp takes part gi, [e0, e1),
// owns the rows whose lists start in it (the last warp also the empty rows
// at the end), and leads with the rest of the row before them (lead).
struct DxShare {
  int E0, E;         // the list [E0, E0 + E)
  int e0, e1;        // the warp's part
  int own0, own1;    // the rows it owns
  bool lead;         // row own0 - 1 runs into the warp's part
  __device__ __forceinline__ int bound(int g, int groups) const {
    return E0 + (int)((long long)E * g / groups);
  }
};

__device__ __forceinline__ DxShare dx_share(const int* bnd, int nr, int gi,
                                            int groups) {
  DxShare d;
  d.E0 = bnd[0];
  d.E = bnd[nr] - d.E0;
  d.e0 = d.bound(gi, groups);
  d.e1 = d.bound(gi + 1, groups);
  d.own0 = first_row_at(bnd, 0, nr, d.e0);
  d.own1 = gi == groups - 1 ? nr : first_row_at(bnd, d.own0, nr, d.e1);
  d.lead = d.own0 > 0 && d.e0 < d.e1 && bnd[d.own0] > d.e0;
  return d;
}

// 4 bf16 as fp32, and 4 fp32 stored rounded to bf16: one 8-byte access
__device__ __forceinline__ void unpack4(const uint2 u, float (&v)[4]) {
  const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 h1 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(h0);
  v[1] = __high2float(h0);
  v[2] = __low2float(h1);
  v[3] = __high2float(h1);
}
__device__ __forceinline__ uint2 pack4(const float (&v)[4]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v[2], v[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                    *reinterpret_cast<const uint32_t*>(&h1));
}

template <int NT>
__global__ void __launch_bounds__(kXThreads<NT>, 1)
dx_bf16_kernel(const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_s, const DxArgs a) {
  constexpr int kStage = kXStage<NT>;
  constexpr int kStages = kXStages<NT>;
  constexpr int kPW = kXPW<NT>;
  constexpr int kBBox = NT * 64 * 2;  // a W box: NT rows of 64 depth
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float4* spill = reinterpret_cast<float4*>(base + kStages * kStage);
  int* row_cnt = reinterpret_cast<int*>(base + kStages * kStage +
                                        kXSpill<NT>);
  int* row_start = row_cnt + 72;  // kXM + 1 of them
  uint64_t* full = reinterpret_cast<uint64_t*>(row_cnt + 2 * 72);
  const Ring ring{full, full + kStages, kStages};
  int* header = reinterpret_cast<int*>(full + 2 * kStages);  // an item a stage
  int* taken = header + kStages;                             // two
  int* hits = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(full) +
                                     kXBarBytes);
  const int hk = a.k / 2, window = hk + 1;
  const int nst = (window + 1) * a.nc;  // stages an item
  if (threadIdx.x == 0) {
    // full: each producer warp, and thread 0's TMA (or the end's) arrival;
    // empty: the consumer warps
    ring.init(kPW + 1, kXConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kXConsumers) {
    // ------------------------------------------------------ the producers
    const int pt = threadIdx.x - kXConsumers;
    const int lane = pt & 31, gi = pt >> 5;
    // lane l holds 4 columns of a stage's 128: the half l % 2 of granule
    // (l % 16) / 2 of slab l / 16
    const int slab = lane >> 4, gq = (lane & 15) >> 1, half = lane & 1;
    int it = 0, gathers = 0;  // ring positions, gather stages
    for (int n = 0;; ++n) {
      if (pt == 0) taken[n & 1] = atomicAdd(a.counter, 1);
      bar_sync(1, 32 * kPW);
      const int item = taken[n & 1];
      if (item >= a.items) {  // one more stage, whose header ends the run
        ring.wait_empty(it);
        if (pt == 0) {
          header[ring.stage(it)] = -1;
          mbar_arrive(ring.full_bar(it));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.full_bar(it));
        break;
      }
      const int rt = item / a.ct, ct = item - rt * a.ct;
      const int q0 = rt * kXM, nr = min(kXM, a.rows - q0);
      const int* tile = a.offsets + q0;  // the tile's slice of the lists
      const int tile0 = __ldg(tile);
      bool listed = false;  // this window's hits listed in shared memory
      DxShare d;
      for (int s = 0; s < nst; ++s, ++it) {
        const int t = s / a.nc, ch = s - t * a.nc;
        if (t < window && ch == 0) {
          // window t's hit list: row r's entries (p, j) with t <= j < t +
          // hk, ascending, as dy_b rows p * hk + j - t; a warp a row at a
          // time, 32 entries a step (counts, one warp's scan, then the
          // list); a tile whose window has more hits than the list holds
          // walks the reverse adjacency instead
          for (int r = gi; r < kXM; r += kPW) {
            int cnt = 0;
            if (r < nr)
              for (int e = __ldg(tile + r) + lane, eb = __ldg(tile + r + 1);
                   e - lane < eb; e += 32) {
                const bool hit =
                    e < eb && (unsigned)(__ldg(&a.dec[e].y) - t) < (unsigned)hk;
                cnt += __popc(__ballot_sync(0xffffffffu, hit));
              }
            if (lane == 0) row_cnt[r] = cnt;
          }
          bar_sync(1, 32 * kPW);
          if (gi == 0) {
            const int c0 = row_cnt[2 * lane], c1 = row_cnt[2 * lane + 1];
            int incl = c0 + c1;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(0xffffffffu, incl, o);
              if (lane >= o) incl += y;
            }
            row_start[2 * lane] = incl - c0 - c1;
            row_start[2 * lane + 1] = incl - c1;
            if (lane == 31) row_start[kXM] = incl;
          }
          bar_sync(1, 32 * kPW);
          listed = row_start[kXM] <= kXCap<NT>;
          bar_sync(1, 32 * kPW);  // every warp has read the total
          if (!listed) {  // the tile's slice of the lists, from its start
            for (int r = pt; r <= kXM; r += 32 * kPW)
              row_start[r] = __ldg(tile + min(r, nr)) - tile0;
            bar_sync(1, 32 * kPW);
          } else {
            for (int r = gi; r < nr; r += kPW) {
              int pos = row_start[r];
              for (int e = __ldg(tile + r) + lane, eb = __ldg(tile + r + 1);
                   e - lane < eb; e += 32) {
                int2 pj = make_int2(0, 0);
                if (e < eb) pj = __ldg(a.dec + e);
                const bool hit = e < eb && (unsigned)(pj.y - t) < (unsigned)hk;
                const unsigned m = __ballot_sync(0xffffffffu, hit);
                if (hit) hits[pos + __popc(m & ((1u << lane) - 1))] = pj.x - t;
                pos += __popc(m);
              }
            }
            bar_sync(1, 32 * kPW);
          }
          d = dx_share(row_start, nr, gi, kPW);
        }
        uint8_t* st = base + ring.stage(it) * kStage;
        ring.wait_empty(it);
        if (pt == 0) {
          uint64_t* bar = ring.full_bar(it);
          header[ring.stage(it)] = item;
          mbar_arrive_tx(bar, 2 * kBBox + (t == window ? 2 * kXSlab : 0));
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load_2d(st + kXABytes + h * kBBox, &map_w, bar,
                        (t * a.nc + ch) * kXK + 64 * h, ct * NT);
          if (t == window)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tma_load_2d(st + h * kXSlab, &map_s, bar, ch * kXK + 64 * h,
                          rt * kXM);
        }
        if (t < window) {
          const int f = ch * kXK + 4 * lane;
          const bool fin = f < a.ld8;
          const __nv_bfloat16* col = a.dyb + f;
          const int buf = gathers & 1;  // alternate spill buffers
          float4* sp = spill + (buf * kPW + gi) * 32 + lane;
          float keep[4];
          int keep_row = -1;
          auto put = [&](int rl, const float (&v)[4]) {
            float lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              lo[j] = v[j] - round_as<__nv_bfloat16>(v[j]);
            const int off =
                rl * 128 + ((gq ^ swizzle_row(rl)) << 4) + 8 * half;
            *reinterpret_cast<uint2*>(st + slab * kXSlab + off) = pack4(v);
            *reinterpret_cast<uint2*>(st + (2 + slab) * kXSlab + off) =
                pack4(lo);
          };
          // row r's sum done: the lead row's part to the spill buffer, a
          // row that runs on kept for after the barrier, a whole one stored
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          auto finish = [&](int r) {
            if (r < d.own0) {
              *sp = make_float4(acc[0], acc[1], acc[2], acc[3]);
            } else if (row_start[r + 1] > d.e1) {
              keep_row = r;
#pragma unroll
              for (int j = 0; j < 4; ++j) keep[j] = acc[j];
            } else {
              put(r, acc);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = 0.f;
          };
          // the warp's part of the list as one stream, kXBatch loads in
          // flight a lane across row ends, summed row by row: the lead row
          // first, then the owned rows in order (empty ones stored as zeros)
          int r = d.lead ? d.own0 - 1 : d.own0;  // the row being summed
          int r_end = r < nr ? row_start[r + 1] : d.e1;
          for (int e = d.e0; e < d.e1; e += kXBatch) {
            uint2 v[kXBatch];
#pragma unroll
            for (int u = 0; u < kXBatch; ++u) {
              v[u] = make_uint2(0, 0);
              if (e + u < d.e1) {
                int row;
                bool hit = true;
                if (listed) {
                  row = hits[e + u];
                } else {
                  const int2 pj = __ldg(a.dec + tile0 + e + u);
                  hit = (unsigned)(pj.y - t) < (unsigned)hk;
                  row = pj.x - t;
                }
                if (hit && fin)
                  v[u] = __ldg(reinterpret_cast<const uint2*>(
                      col + (size_t)row * a.ld8));
              }
            }
#pragma unroll
            for (int u = 0; u < kXBatch; ++u) {
              if (e + u >= d.e1) break;
              while (e + u >= r_end) {  // rows that end here (or are empty)
                finish(r);
                ++r;
                r_end = row_start[r + 1];
              }
              float y[4];
              unpack4(v[u], y);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[j] += y[j];
            }
          }
          // the row being summed, then the warp's empty rows after it
          if (r < d.own1 || (d.lead && r == d.own0 - 1)) {
            finish(r);
            for (++r; r < d.own1; ++r) finish(r);
          }
          // (the last warp) zeros for the tile's rows past the end
          if (gi == kPW - 1) {
            const float z[4] = {0.f, 0.f, 0.f, 0.f};
            for (int rr = nr; rr < kXM; ++rr) put(rr, z);
          }
          bar_sync(1, 32 * kPW);  // every warp's spilled parts written
          // a row that ran on: the later warps' parts, in warp order (a
          // warp with an empty part spilled nothing)
          if (keep_row >= 0) {
            const int kend = row_start[keep_row + 1];
            for (int g2 = gi + 1; g2 < kPW; ++g2) {
              const int b0 = d.bound(g2, kPW), b1 = d.bound(g2 + 1, kPW);
              if (b0 >= kend) break;
              if (b0 == b1) continue;
              const float4 x = spill[(buf * kPW + g2) * 32 + lane];
              keep[0] += x.x;
              keep[1] += x.y;
              keep[2] += x.z;
              keep[3] += x.w;
            }
            put(keep_row, keep);
          }
          ++gathers;
          fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.full_bar(it));
      }
    }
    return;
  }

  // ------------------------------------------------------- the consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  for (int it = 0;;) {
    ring.wait_full(it);
    const int item = header[ring.stage(it)];
    if (item < 0) break;
    const int rt = item / a.ct, ct = item - rt * a.ct;
    for (int s = 0; s < nst; ++s, ++it) {
      if (s > 0) ring.wait_full(it);
      const uint8_t* st = base + ring.stage(it) * kStage;
      const bool lo = s / a.nc < window;  // not S: the lo slabs too
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t db = sw128_desc(st + kXABytes + h * kBBox);
        const uint64_t dh = sw128_desc(st + h * kXSlab);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<NT>(acc, dh + 2 * kk, db + 2 * kk, 1);
        if (lo) {
          const uint64_t dl = sw128_desc(st + (2 + h) * kXSlab);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16<NT>(acc, dl + 2 * kk, db + 2 * kk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      if (s > 0 && lane == 0) ring.release(it - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) ring.release(it - 1);
    // rows row0 and row0 + 8 of columns c0 + 8 i (+ 1): (dxm + acc) rounded
    // once, AddStoreTo's order
    const int row0 = rt * kXM + warp * 16 + g;
    const int c0 = ct * NT + 2 * t4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= a.rows) continue;
      const float* dr = a.dxm + (size_t)row * a.c8;
      __nv_bfloat16* o = a.d_x + (size_t)row * a.c8;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        const int c = c0 + 8 * i;
        if (c < a.c8) {
          const float2 m = __ldg(reinterpret_cast<const float2*>(dr + c));
          *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(
              m.x + acc[4 * i + 2 * hr], m.y + acc[4 * i + 2 * hr + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  }
}

template <int NT>
cudaError_t launch_dx_bf16(const __nv_bfloat16* w_dx, long long wcols,
                           const __nv_bfloat16* sb, DxArgs a, int grid,
                           cudaStream_t stream) {
  CUtensorMap map_w, map_s;
  cudaError_t err = bf16_tile_map(&map_w, w_dx, a.c8, wcols, wcols, NT);
  if (err != cudaSuccess) return err;
  err = bf16_tile_map(&map_s, sb, a.rows, a.ld8, a.ld8, kXM);
  if (err != cudaSuccess) return err;
  a.ct = (a.c8 + NT - 1) / NT;
  const long long items = (long long)((a.rows + kXM - 1) / kXM) * a.ct;
  if (items >= (1LL << 30)) return cudaErrorInvalidValue;
  a.items = (int)items;
  err = cudaMemsetAsync(a.counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dx_bf16_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kXSmemBytes<NT>);
  if (err != cudaSuccess) return err;
  if (grid > a.items) grid = a.items;
  dx_bf16_kernel<NT><<<grid, kXThreads<NT>, kXSmemBytes<NT>, stream>>>(map_w,
                                                                  map_s, a);
  return cudaGetLastError();
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
// d_inte, pcat, ppoint, d_wfea, d_wxyz; c8, ld8 and t8: C, 4Fin and 2F
// rounded up to 8 (a bf16 granule); w_dx (c8, (window+1)*ldk) bf16, ldk =
// 4Fin rounded up to kXK = 128 (the wrapper's BWD_DX_CHUNK; passed in and
// checked here): row c holds [Wn_0[c] | .. | Wn_{window-1}[c] |
// conv_a[c]], each block ldk wide; w_dm ((k+1)*c8, t8) bf16: row j*c8 + c
// holds wen_j[c] (j < k) or a_merge[c]; zero pads; d_partial (B,N,2F) fp32
// unpadded (its bias sums) and dpart_b (B,N,t8) its bf16 rounding,
// zero-padded (the products' operand). x, inte, d_inte, w_*, dpart_b and
// the scratch 16-byte aligned. Outputs: d_x (B,N,c8), d_pcat, d_ppoint
// bf16; d_wn (window*c8, ld8), d_ca (c8, ld8), d_wm ((k+1)*c8, t8),
// d_pb_point, d_pb_merge fp32. Scratch: dyb (B*N, hk, ld8) and sb (B*N,
// ld8) bf16, spart (B*N / rpb, 4Fin) fp32 (rpb: the dy pass's rows a
// block, chosen by the wrapper's head_bwd_rows_per_block; it divides N),
// xg (B*N, k+1, c8) bf16, dm (B*N,
// (k+1)*c8), dxm (B*N, c8), part (the largest of split_* x the weight
// products' outputs), one counter int, dec (B*N*k int2, 8-byte aligned),
// count, cursor, offsets, entries as there. sms: the d_x kernel's grid; split_wn, split_ca, split_wm: the row
// splits of the three weight products (1 <= split <= their depth stages).
int pdgn_edge_head_bwd_bf16(
    const __nv_bfloat16* x, const int* idx, const int* nbr,
    const __nv_bfloat16* inte, int B, int N, int c8, int k, int four_fin,
    int two_f, int ld8, int t8, const __nv_bfloat16* w_dx,
    const __nv_bfloat16* w_dm, const __nv_bfloat16* d_inte,
    const float* d_partial, const __nv_bfloat16* dpart_b,
    const float* d_stats, const __nv_bfloat16* pcat,
    const __nv_bfloat16* ppoint, const __nv_bfloat16* d_wfea,
    const __nv_bfloat16* d_wxyz, const float* d_wstats, __nv_bfloat16* d_x,
    float* d_wn, float* d_ca, float* d_wm, float* d_pb_point,
    float* d_pb_merge, __nv_bfloat16* d_pcat, __nv_bfloat16* d_ppoint,
    __nv_bfloat16* dyb, float* spart, __nv_bfloat16* sb, __nv_bfloat16* xg,
    float* dm, float* dxm, float* part, int* counter, int* dec, int* count,
    int* cursor, int* offsets, int* entries, int sms, int rpb, int ldk,
    int split_wn, int split_ca, int split_wm, cudaStream_t stream) {
  if (c8 % 8 || ld8 % 8 || t8 % 8 || ld8 < four_fin || t8 < two_f ||
      k < 2 || k % 2 || sms < 1 || rpb < 1 || N % rpb || ldk % kXK ||
      ldk < four_fin || ldk - four_fin >= kXK)
    return (int)cudaErrorInvalidValue;
  const int rows = B * N;
  const int hk = k / 2;
  const int window = hk + 1;
  const int mc = (k + 1) * c8;
  const int nc = ldk / kXK;
  const int dblocks = (rows + kPK - 1) / kPK;

  // 1. the reverse adjacency of the graph
  cudaError_t err = reverse_adjacency(idx, B, N, k, N, count, cursor, offsets,
                                      entries, stream);
  if (err != cudaSuccess) return (int)err;

  // 2. the merge's cotangents of every neighbour block, dm = dpart_b w_dm^T
  CUtensorMap map_a, map_b;
  err = bf16_tile_map_3d(&map_a, dpart_b, t8, 1, rows, t8, t8, 64, 1, kPM);
  if (err != cudaSuccess) return (int)err;
  err = bf16_tile_map_3d(&map_b, w_dm, t8, 1, mc, t8, t8, 64, 1, kPN);
  if (err != cudaSuccess) return (int)err;
  ProductArgs pa{rows, 1, (rows + kPM - 1) / kPM, mc, 1, (t8 + kPK - 1) / kPK,
                 0, 0, dm, mc};
  err = launch_product_bf16<false>(map_a, map_b, pa, 1, stream);
  if (err != cudaSuccess) return (int)err;

  // 3. dy_b, S, the gathered x blocks and dxm, rpb rows a block (their S
  // in shared memory: past 48 KB only where the card allows it)
  const int dy_smem = rpb * ld8 * 4;
  if (dy_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(four_fin % 8 ? dy_pass_bf16_kernel<1>
                                            : dy_pass_bf16_kernel<8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dy_smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (four_fin % 8 == 0)
    dy_pass_bf16_kernel<8><<<rows / rpb, kDyThreads, dy_smem, stream>>>(
        inte, d_inte, d_stats, x, nbr, dm, offsets, entries, k, four_fin, ld8,
        c8, rpb, dyb, spart, sb, xg, dxm, reinterpret_cast<int2*>(dec));
  else
    dy_pass_bf16_kernel<1><<<rows / rpb, kDyThreads, dy_smem, stream>>>(
        inte, d_inte, d_stats, x, nbr, dm, offsets, entries, k, four_fin, ld8,
        c8, rpb, dyb, spart, sb, xg, dxm, reinterpret_cast<int2*>(dec));
  PDGN_CHECK_LAUNCH();

  // 4. the input gradient in one launch, rounded to bf16 at the store
  const DxArgs dx{dyb, dxm, offsets, reinterpret_cast<const int2*>(dec),
                  d_x, counter, rows, k, ld8, c8, nc, 0, 0};
  const long long wcols = (long long)(window + 1) * ldk;
  if (c8 <= 64)
    err = launch_dx_bf16<64>(w_dx, wcols, sb, dx, sms, stream);
  else if (c8 <= 128)
    err = launch_dx_bf16<128>(w_dx, wcols, sb, dx, sms, stream);
  else
    err = launch_dx_bf16<256>(w_dx, wcols, sb, dx, sms, stream);
  if (err != cudaSuccess) return (int)err;

  // 5. the weight gradients: A = the gathered x blocks, at block a_slot0 +
  // g * a_slot_g + w of each row; split partials added in order
  err = bf16_tile_map_3d(&map_a, xg, c8, k + 1, rows, c8, (long long)mc, 64, 1,
                         kPK);
  if (err != cudaSuccess) return (int)err;
  const int mt = (c8 + kPM - 1) / kPM;
  struct Tn {
    const __nv_bfloat16* b;
    int ldb, nw, groups, slot0, slot_g, splits;
    float* out;
  };
  const Tn tn[3] = {
      {dyb, ld8, hk, window, 0, 1, split_wn, d_wn},   // x[nbr[p, wp+t]]^T dy_b
      {sb, ld8, 1, 1, k, 0, split_ca, d_ca},          // x^T S_b
      {dpart_b, t8, 1, k + 1, 0, 1, split_wm, d_wm}}; // [x[nbr] | x]^T dpart_b
  for (const Tn& o : tn) {
    err = bf16_tile_map_3d(&map_b, o.b, o.ldb, o.nw, rows, o.ldb,
                           (long long)o.nw * o.ldb, 64, 1, kPK);
    if (err != cudaSuccess) return (int)err;
    const ProductArgs p{c8, o.groups, mt, o.ldb, o.nw, dblocks, o.slot0,
                        o.slot_g, part, o.ldb};
    err = launch_product_bf16<true>(map_a, map_b, p, o.splits, stream);
    if (err != cudaSuccess) return (int)err;
    column_reduce(part, o.splits, o.groups * c8 * o.ldb, o.out, stream);
    PDGN_CHECK_LAUNCH();
  }

  // 6. per-batch bias gradients from S's block partials and d_partial
  chunk_colsum(PlainA{spart, four_fin}, (long long)(rows / rpb), four_fin,
               N / rpb, d_pb_point, stream);
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
