// Edge-conv stage tail backward for Hopper (sm_90a).
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/bilateral_tail.py::
// _gated_bwd_kernel (stages 2-4) and ::_plain_bwd_kernel (stage 1), launcher
// _bwd_pallas: the VJP of y = partial + g @ wi + bias with
// g = LeakyReLU(inte*isc + ish) * u, u = softmax_slots(LeakyReLU(v*s2 + t2)),
// v = h@w2k + w2b (u = 1 on the plain stage). Given dy:
//   d_partial = dy (the caller's), d_bias = sum dy, d_wi = g^T dy,
//   dg = dy wi^T, and per (point, slot, channel) the walk back through the
//   gate, the LeakyReLUs, the slot softmax and the folded batch norms:
//   d_inte, d_isc, d_ish, d_h = dv w2k^T, d_w2k = h^T dv, d_w2b, d_s2, d_t2.
//
// What bounds it on the H100: operations. At stage 4, B=35 the two large
// products (dg and d_wi, 188 GFLOP each) and the three of width 64 (d_h,
// d_w2k, the recomputed conv_all2: 23.5 each) run on the tensor cores in
// 3xTF32 (495 / 3 TFLOP/s of fp32-accurate work), against ~3.8 GB that the
// gate pass moves.
//
// The design, every product on the shared core (tf32x3_gemm.cuh, folded):
//   1. dg = dy wi^T (it does not need g);
//   2. the gate pass (gate_bwd_tc_kernel): the forward gate's tile,
//      fragments, staging and logit code (tail_gate.cuh) with dg staged
//      beside h and inte in one cp.async group; it recomputes the slot
//      logits once as 3xTF32 products, writes g (the forward's bit for
//      bit, for d_wi), then walks back through the gate, the softmax, the
//      LeakyReLUs and the BN folds thread-locally and writes d_inte and dv
//      (each LeakyReLU branch by the exact sign of its input, below).
//      Its channel sums reduce over the warp's rows by shuffles in a fixed
//      order and go per block to scratch, added in order by column_reduce.
//      The plain stage takes plain_gate_bwd_kernel, elementwise, likewise
//      writing g;
//   3. d_h = dv w2k^T, d_w2k = h^T dv, d_wi = g^T dy; the weight gradients
//      reduce over 4096-row splits added in a fixed order.
// Nothing uses float atomics: the gradients are deterministic.
#include "tail_gate.cuh"
#include "tf32x3_gemm.cuh"

namespace {

constexpr int kSums = 7;  // isc j0 | isc j1 | ish j0 | ish j1 | s2 | t2 | w2b

// LeakyReLU's derivative times d, as PyTorch takes it (0.01 at pre == 0)
__device__ __forceinline__ float leaky_grad(float pre, float d) {
  return pre > 0.f ? d : 0.01f * d;
}

// The gradient jumps at LeakyReLU's kink, so its branch is taken by the
// exact sign: inte*isc + ish is one fmaf (its sign is exact), and a slot
// logit's bn_all2 input v*s2 + t2, whose v comes from the tensor cores,
// is recomputed in double from the staged h row and w2k's column c where
// it lies within their error bound (kink) of 0. Not inlined: few positions
// take it.
__device__ __noinline__ bool exact_pre_positive(const float* hrow,
                                                const float* __restrict__ w2k,
                                                int two_fin, int c,
                                                float bias, float sc,
                                                float sh) {
  double a = 0.0;
  for (int j = 0; j < kHidden; ++j)
    a = fma((double)hrow[j], (double)w2k[(size_t)j * two_fin + c], a);
  return (a + bias) * sc + sh > 0.0;
}

// The gate's backward on the tensor cores. The tile, the warps' channel
// columns and the fragments are gate_tc_kernel's; h, inte and dg of the
// tile are staged in one cp.async group (3 x 16 rows of hl floats, one
// block an SM). Per tile:
//   the slot logits U_s (slot_conv: 3xTF32 m16n8k8 products), kept as
//   conv_all2's outputs v in registers (KR = 10 or 16 slots), and the
//   softmax's m and rz formed as the forward forms them, so that the
//   weight expf(U_s - m) * rz and the g written are the forward's bits;
//   walk A, slot by slot: g, d_inte, the BN sums of inte and
//   dot = sum_s w_s du_s with du_s = dg_s LeakyReLU(inte_s*isc + ish);
//   walk B: da_s = w_s (du_s - dot) back through the logit's LeakyReLU and
//   bn_all2 into dv and the sums of d_s2, d_t2, d_w2b; the LeakyReLU
//   branch by the sign of v*s2 + t2 in double where the tensor cores'
//   value lies within the kink bound of 0.
// KR == 0 (k > 16): as gate_tc_kernel<0>, chunks of 16 staged slots,
// logits recomputed each pass: pass 1 the online m and z (the forward's
// weights are expf(U_s - m) / z), pass 2 walk A, pass 3 walk B.
// dv's pad columns [2Fin, ldv) are written as zeros (d_h's depth).
template <int KR>
__global__ void __launch_bounds__(32 * kGateWarps, 1)
gate_bwd_tc_kernel(const float* __restrict__ inte,
                   const float* __restrict__ h, const float* __restrict__ dg,
                   const float* __restrict__ isc,
                   const float* __restrict__ ish,
                   const float* __restrict__ w2k,
                   const float* __restrict__ w2b,
                   const float* __restrict__ s2,
                   const float* __restrict__ t2,
                   const float* __restrict__ kink, int rows, int k,
                   int two_fin, int ldg, int ldv, int softmax,
                   float* __restrict__ g_out, float* __restrict__ d_inte,
                   float* __restrict__ dv, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = k < kGateChunk ? k : kGateChunk;
  const int hl = kc * kHidden + 4;
  const int c0 = blockIdx.x * kGateC;
  const int cl = warp * 8 + 2 * t;
  const int c = c0 + cl;
  const size_t K = (size_t)k * two_fin;  // inte's row: k/2 * 4Fin
  GateThread th;
  th.load(isc, ish, w2k, w2b, s2, t2, c, c0 + warp * 8 + g, t, two_fin);
  float* sh = smem;
  float* si = sh + kGateP * hl;
  float* sd = si + kGateP * hl;
  const float kq[2] = {th.live[0] ? kink[c] : -1.f,
                       th.live[1] ? kink[c + 1] : -1.f};

  // sums[m][q]: the thread's share of the seven channel sums of c + q
  float sums[kSums][2];
#pragma unroll
  for (int m = 0; m < kSums; ++m) sums[m][0] = sums[m][1] = 0.f;
  // the softmax at the thread's four positions: maximum m and, k <= 16,
  // the reciprocal normaliser, else the normaliser
  float m[4], nz[4], dot[4];
  auto weight = [&](float u, int q) {
    if (!softmax) return u;
    return KR > 0 ? expf(u - m[q]) * nz[q] : expf(u - m[q]) / nz[q];
  };

  // walk A of slot s (staged at sl) given its conv_all2 outputs v
  auto walk_a = [&](int p0, int s, int sl, const float v[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      const bool row = p0 + r < rows;
      const size_t o = (size_t)(p0 + r) * K + (size_t)s * two_fin + c;
      const size_t og = (size_t)(p0 + r) * ldg + (size_t)s * two_fin + c;
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const int q = 2 * half + qq;
        const float w = weight(slot_logit(v[q], th.sc[qq], th.shf[qq]), q);
        const float x = si[r * hl + sl * kHidden + cl + qq];
        const float dgv = sd[r * hl + sl * kHidden + cl + qq];
        const float a = th.isc(s, qq);
        const float gpre = gate_pre(x, a, th.ish(s, qq));
        const float lg = leaky(gpre);
        const float dgpre = leaky_grad(gpre, dgv * w);
        if (s & 1) {
          sums[1][qq] += dgpre * x;
          sums[3][qq] += dgpre;
        } else {
          sums[0][qq] += dgpre * x;
          sums[2][qq] += dgpre;
        }
        dot[q] += w * (dgv * lg);
        if (row && th.live[qq]) {
          g_out[og + qq] = lg * w;
          d_inte[o + qq] = dgpre * a;
        }
      }
    }
  };

  // walk B of slot s (staged at sl)
  auto walk_b = [&](int p0, int s, int sl, const float v[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      float out[2];
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const int q = 2 * half + qq;
        const float upre = slot_pre(v[q], th.sc[qq], th.shf[qq]);
        const float w = weight(leaky(upre), q);
        const float x = si[r * hl + sl * kHidden + cl + qq];
        const float dgv = sd[r * hl + sl * kHidden + cl + qq];
        const float gpre = gate_pre(x, th.isc(s, qq), th.ish(s, qq));
        const float du = dgv * leaky(gpre);
        const float da = softmax ? w * (du - dot[q]) : du;
        bool up = upre > 0.f;
        if (fabsf(upre) <= kq[qq])
          up = exact_pre_positive(sh + r * hl + sl * kHidden, w2k, two_fin,
                                  c + qq, th.bias[qq], th.sc[qq],
                                  th.shf[qq]);
        const float dpre = up ? da : 0.01f * da;
        sums[4][qq] += dpre * v[q];
        sums[5][qq] += dpre;
        out[qq] = dpre * th.sc[qq];
        sums[6][qq] += out[qq];
      }
      if (p0 + r < rows && c < ldv) {
        // c even, ldv a multiple of 4: the pair fits, 8-byte aligned
        *reinterpret_cast<float2*>(dv + ((size_t)(p0 + r) * k + s) * ldv +
                                   c) =
            make_float2(th.live[0] ? out[0] : 0.f, th.live[1] ? out[1] : 0.f);
      }
    }
  };

  const int tiles = (rows + kGateP - 1) / kGateP;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int p0 = tile * kGateP;
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[q] = 0.f;
    if constexpr (KR > 0) {
      __syncthreads();  // the previous tile's rows are read
      stage_tile(sh, si, sd, hl, h, inte, dg, ldg, rows, k, two_fin, c0, p0,
                 0, k);
      cp_async_wait<0>();
      __syncthreads();
      float v[KR][4];
#pragma unroll
      for (int s = 0; s < KR; ++s)
        if (s < k)
          slot_conv(sh + s * kHidden, hl, g, t, th.bhi, th.blo, th.bias,
                    v[s]);
      if (softmax) {
        // gate_tc_kernel's order: the maximum, z summed over ascending
        // slots, one reciprocal
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float sc = th.sc[q & 1], sf = th.shf[q & 1];
          float mx = slot_logit(v[0][q], sc, sf);
#pragma unroll
          for (int s = 1; s < KR; ++s)
            if (s < k) mx = fmaxf(mx, slot_logit(v[s][q], sc, sf));
          float z = 0.f;
#pragma unroll
          for (int s = 0; s < KR; ++s)
            if (s < k) z += expf(slot_logit(v[s][q], sc, sf) - mx);
          m[q] = mx;
          nz[q] = 1.f / z;
        }
      }
#pragma unroll
      for (int s = 0; s < KR; ++s)
        if (s < k) walk_a(p0, s, s, v[s]);
#pragma unroll
      for (int s = 0; s < KR; ++s)
        if (s < k) walk_b(p0, s, s, v[s]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m[q] = -INFINITY;
        nz[q] = 0.f;
      }
      for (int s0 = 0; s0 < k && softmax; s0 += kGateChunk) {
        const int ns = k - s0 < kGateChunk ? k - s0 : kGateChunk;
        __syncthreads();
        stage_tile(sh, nullptr, nullptr, hl, h, inte, dg, ldg, rows, k,
                   two_fin, c0, p0, s0, ns);
        cp_async_wait<0>();
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
          float u[4];
          th.logits(sh + s * kHidden, hl, g, t, u);
#pragma unroll
          for (int q = 0; q < 4; ++q) online_softmax(m[q], nz[q], u[q]);
        }
      }
      for (int pass = 0; pass < 2; ++pass) {
        for (int s0 = 0; s0 < k; s0 += kGateChunk) {
          const int ns = k - s0 < kGateChunk ? k - s0 : kGateChunk;
          __syncthreads();
          stage_tile(sh, si, sd, hl, h, inte, dg, ldg, rows, k, two_fin, c0,
                     p0, s0, ns);
          cp_async_wait<0>();
          __syncthreads();
          for (int s = 0; s < ns; ++s) {
            float v[4];
            slot_conv(sh + s * kHidden, hl, g, t, th.bhi, th.blo, th.bias,
                      v);
            if (pass == 0)
              walk_a(p0, s0 + s, s, v);
            else
              walk_b(p0, s0 + s, s, v);
          }
        }
      }
    }
  }

  // the block's sums: over the warp's eight rows g (a fixed butterfly),
  // then one row of scratch per blockIdx.y
#pragma unroll
  for (int mm = 0; mm < kSums; ++mm)
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      float v = sums[mm][qq];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0 && th.live[qq])
        scratch[((size_t)blockIdx.y * kSums + mm) * two_fin + c + qq] = v;
    }
}

// the gate backward's grid rows: tiles of 16 points, at most 65535
inline int gate_bwd_blocks(int rows) {
  const int tiles = (rows + kGateP - 1) / kGateP;
  return tiles < 65535 ? tiles : 65535;
}

template <int KR>
cudaError_t launch_gate_bwd_tc(int k, const float* inte, const float* h,
                               const float* dg, const float* isc,
                               const float* ish, const float* w2k,
                               const float* w2b, const float* s2,
                               const float* t2, const float* kink, int rows,
                               int two_fin,
                               int ldg, int ldv, int softmax, float* g,
                               float* d_inte, float* dv, float* scratch,
                               cudaStream_t stream) {
  const int kc = k < kGateChunk ? k : kGateChunk;
  const int smem = 3 * kGateP * (kc * kHidden + 4) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gate_bwd_tc_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((two_fin + kGateC - 1) / kGateC, gate_bwd_blocks(rows));
  gate_bwd_tc_kernel<KR><<<grid, 32 * kGateWarps, smem, stream>>>(
      inte, h, dg, isc, ish, w2k, w2b, s2, t2, kink, rows, k, two_fin, ldg,
      ldv, softmax, g, d_inte, dv, scratch);
  return cudaGetLastError();
}

constexpr int kPlainRows = 64;  // rows (point, window) per plain-stage block

// plain stage: g = LeakyReLU(inte*isc + ish) (the forward's) and d_inte =
// LeakyReLU'(inte*isc + ish) * dg * isc, one thread per (row chunk,
// channel), the chunk's sums of d_isc and d_ish to scratch. Row r is
// (point r / hk, window r % hk); g and dg have ldg columns.
__global__ void plain_gate_bwd_kernel(const float* __restrict__ inte,
                                      const float* __restrict__ isc,
                                      const float* __restrict__ ish,
                                      const float* __restrict__ dg,
                                      long long rows, int hk, int four_fin,
                                      int ldg, float* __restrict__ g,
                                      float* __restrict__ d_inte,
                                      float* __restrict__ scratch) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= four_fin) return;
  const long long r0 = (long long)blockIdx.y * kPlainRows;
  long long r1 = r0 + kPlainRows;
  if (r1 > rows) r1 = rows;
  const float a = isc[ch], b = ish[ch];
  float s_isc = 0.f, s_ish = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * four_fin + ch;
    const long long p = r / hk;
    const size_t og = (size_t)p * ldg + (size_t)(r - p * hk) * four_fin + ch;
    const float in = inte[o];
    const float gpre = gate_pre(in, a, b);
    const float dgpre = leaky_grad(gpre, dg[og]);
    g[og] = leaky(gpre);
    d_inte[o] = dgpre * a;
    s_isc += dgpre * in;
    s_ish += dgpre;
  }
  float* out = scratch + (size_t)blockIdx.y * 2 * four_fin;
  out[ch] = s_isc;
  out[four_fin + ch] = s_ish;
}

}  // namespace

extern "C" {

// Forward operands: inte (rows, K) with K = k/2*4Fin = k*2Fin, and h
// (rows, k*64), 16-byte aligned, or h null (plain stage: w2k..t2, w2k_t,
// d_h, d_w2k, dv ignored); isc/ish (4Fin), w2k (64, 2Fin), w2k_t (ldv, 64)
// with zero rows past 2Fin, w2b/s2/t2 (2Fin), kink (2Fin: the bound on
// the tensor cores' error in v*s2 + t2 within which of 0 the slot logit's
// LeakyReLU branch is taken in double), wi_t (t4, ldg) = wi^T
// zero-padded; dy (rows, t4) zero-padded. ldg >= K, t4 >= 2F and ldv >=
// 2Fin multiples of 4.
// Outputs: d_inte like inte, d_h like h, d_w2k (64, 2Fin), d_wi (ldg, 2F)
// (rows past K are the pad's), d_bias (2F), sums: gated (7, 2Fin) = [d_isc
// (4Fin) | d_ish (4Fin) | d_s2 | d_t2 | d_w2b], plain (2, 4Fin) = [d_isc |
// d_ish]. Scratch: g and dg (rows, ldg), dv (rows*k, ldv), tn_scratch (the
// larger split partials of d_wi and d_w2k), sum_scratch (gated:
// min(ceil(rows/16), 65535) rows of 7*2Fin; plain: ceil(rows*k/2/64) rows
// of 2*4Fin), colsum (ceil(rows/256), 2F).
int pdgn_bilateral_tail_bwd(
    const float* inte, const float* h, const float* isc, const float* ish,
    const float* w2k, const float* w2k_t, const float* w2b, const float* s2,
    const float* t2, const float* kink, const float* wi_t, const float* dy,
    int rows, int k, int two_fin, int two_f, int ldg, int t4, int ldv,
    int softmax,
    float* d_inte, float* d_h, float* d_w2k, float* d_wi, float* d_bias,
    float* sums, float* g, float* dg, float* dv, float* tn_scratch,
    float* sum_scratch, float* colsum, cudaStream_t stream) {
  const int hk = k / 2;
  const int four_fin = 2 * two_fin;
  const int K = k * two_fin;
  if (k < 2 || k % 2 || ldg < K || ldg % 4 || t4 < two_f || t4 % 4 ||
      (h != nullptr && (ldv < two_fin || ldv % 4 || k > kGateMaxK)))
    return (int)cudaErrorInvalidValue;

  // 1. dg = dy wi^T, and d_bias
  cudaError_t err = tc_gemm<false, kGFold>(RowsA{dy, t4}, wi_t, ldg, rows, K,
                                           t4, t4, StorePairs{dg, ldg},
                                           stream);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (rows + 255) / 256;
  chunk_colsum(PlainA{dy, t4}, (long long)rows, two_f, 256, colsum, stream);
  column_reduce(colsum, nchunk, two_f, d_bias, stream);
  PDGN_CHECK_LAUNCH();

  // 2. the gate pass: g, d_inte, dv and the sums
  if (h != nullptr) {
    if (k <= 10)
      err = launch_gate_bwd_tc<10>(k, inte, h, dg, isc, ish, w2k, w2b, s2,
                                   t2, kink, rows, two_fin, ldg, ldv,
                                   softmax, g, d_inte, dv, sum_scratch,
                                   stream);
    else if (k <= kGateChunk)
      err = launch_gate_bwd_tc<kGateChunk>(k, inte, h, dg, isc, ish, w2k,
                                           w2b, s2, t2, kink, rows, two_fin,
                                           ldg, ldv, softmax, g, d_inte, dv,
                                           sum_scratch, stream);
    else
      err = launch_gate_bwd_tc<0>(k, inte, h, dg, isc, ish, w2k, w2b, s2, t2,
                                  kink, rows, two_fin, ldg, ldv, softmax, g,
                                  d_inte, dv, sum_scratch, stream);
    if (err != cudaSuccess) return (int)err;
    column_reduce(sum_scratch, gate_bwd_blocks(rows), kSums * two_fin, sums,
                  stream);
    PDGN_CHECK_LAUNCH();
    // 3. conv_all2's backward
    const int hrows = rows * k;
    err = tc_gemm<false, kGFold>(RowsA{dv, ldv}, w2k_t, kHidden, hrows,
                                 kHidden, ldv, ldv,
                                 StorePairs{d_h, kHidden}, stream);
    if (err != cudaSuccess) return (int)err;
    err = tc_gemm_tn(RowsA{h, kHidden}, dv, ldv, hrows, kHidden, two_fin,
                     tn_scratch, d_w2k, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    const long long prow = (long long)rows * hk;
    const int nblk = (int)((prow + kPlainRows - 1) / kPlainRows);
    dim3 grid((four_fin + 127) / 128, nblk);
    plain_gate_bwd_kernel<<<grid, 128, 0, stream>>>(
        inte, isc, ish, dg, prow, hk, four_fin, ldg, g, d_inte, sum_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(sum_scratch, nblk, 2 * four_fin, sums, stream);
    PDGN_CHECK_LAUNCH();
  }

  // 3. d_wi = g^T dy
  return (int)tc_gemm_tn(RowsA{g, ldg}, dy, t4, rows, ldg, two_f, tn_scratch,
                         d_wi, stream);
}

}  // extern "C"
