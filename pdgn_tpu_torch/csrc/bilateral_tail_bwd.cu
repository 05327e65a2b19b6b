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
// What bounds it on the H100: operations. At stage 4 one cloud costs
// 2 x 5.4 GFLOP for dg and d_wi, 2 x 0.7 GFLOP for d_h and d_w2k and 0.7 to
// recompute the gate's conv_all2, against ~60 MB of traffic.
//
// The simple design:
//   1. The gate g is recomputed from inte and h (tail_gate.cuh, the
//      forward's own kernel) rather than kept from the forward: at stage 4,
//      B=35 it is 0.73 GB, and the TPU kernel keeps nothing of that size.
//   2. d_wi = g^T dy is a transposed GEMM reduced over 4096-row splits added
//      in a fixed order; then dg = dy wi^T overwrites g's buffer.
//   3. gate_bwd_kernel: a thread owns one (point, conv_all2 channel) as in
//      the forward, recomputes the k slots' conv_all2 from shared memory,
//      writes d_inte and dv, and keeps its channel sums in registers; the
//      sums go per block to scratch and column_reduce adds them in order.
//   4. d_h and d_w2k are a GEMM and a transposed GEMM over dv.
// Nothing uses float atomics: the gradients are deterministic.
#include "tail_gate.cuh"

namespace {

constexpr int kSums = 7;  // isc j0 | isc j1 | ish j0 | ish j1 | s2 | t2 | w2b

__device__ __forceinline__ float leaky_grad(float pre, float d) {
  return pre >= 0.f ? d : 0.01f * d;
}

__global__ void __launch_bounds__(256)
gate_bwd_kernel(const float* __restrict__ inte, const float* __restrict__ h,
                const float* __restrict__ isc, const float* __restrict__ ish,
                const float* __restrict__ w2k, const float* __restrict__ w2b,
                const float* __restrict__ s2, const float* __restrict__ t2,
                const float* __restrict__ dg, int rows, int k, int two_fin,
                int softmax, float* __restrict__ d_inte,
                float* __restrict__ dv, float* __restrict__ scratch) {
  __shared__ float sw[kHid][kTC];
  __shared__ float shh[kSubP][kMaxK * kHid];
  __shared__ float red[kSubP][kSums][kTC];

  const int tid = threadIdx.x;
  const int cl = tid % kTC;
  const int pl = tid / kTC;
  const int c0 = blockIdx.x * kTC;
  const int c = c0 + cl;
  const int hk = k / 2;
  const int four_fin = 2 * two_fin;

  for (int e = tid; e < kHid * kTC; e += 256) {
    int hh = e / kTC, cc = e % kTC;
    sw[hh][cc] = (c0 + cc < two_fin) ? w2k[(size_t)hh * two_fin + c0 + cc] : 0.f;
  }
  const bool live_c = c < two_fin;
  const float bias = live_c ? w2b[c] : 0.f;
  const float sc = live_c ? s2[c] : 0.f;
  const float sh = live_c ? t2[c] : 0.f;
  const float isc0 = live_c ? isc[c] : 0.f, isc1 = live_c ? isc[two_fin + c] : 0.f;
  const float ish0 = live_c ? ish[c] : 0.f, ish1 = live_c ? ish[two_fin + c] : 0.f;

  float sums[kSums];
#pragma unroll
  for (int m = 0; m < kSums; ++m) sums[m] = 0.f;

  const int p_begin = blockIdx.y * kBlockP;
  const int p_end = min(rows, p_begin + kBlockP);
  const int width = k * kHid;
  for (int p0 = p_begin; p0 < p_end; p0 += kSubP) {
    __syncthreads();
    for (int e = tid; e < kSubP * width; e += 256) {
      int pp = e / width, rem = e % width;
      shh[pp][rem] = (p0 + pp < p_end) ? h[(size_t)(p0 + pp) * width + rem] : 0.f;
    }
    __syncthreads();
    const int p = p0 + pl;
    if (p >= p_end || !live_c) continue;

    float v[kMaxK], upre[kMaxK], u[kMaxK], du[kMaxK];
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) {
        float a = 0.f;
#pragma unroll 16
        for (int hh = 0; hh < kHid; ++hh)
          a = fmaf(shh[pl][s * kHid + hh], sw[hh][cl], a);
        v[s] = a + bias;
        upre[s] = v[s] * sc + sh;
        u[s] = leaky(upre[s]);
      }
    }
    if (softmax) {
      float m = u[0];
#pragma unroll
      for (int s = 1; s < kMaxK; ++s)
        if (s < k) m = fmaxf(m, u[s]);
      float z = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxK; ++s)
        if (s < k) {
          u[s] = expf(u[s] - m);
          z += u[s];
        }
#pragma unroll
      for (int s = 0; s < kMaxK; ++s)
        if (s < k) u[s] = u[s] / z;
    }
    const size_t base = (size_t)p * hk * four_fin;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) {
        const int j = s % 2;
        const size_t o = base + (size_t)(s / 2) * four_fin + j * two_fin + c;
        const float in = inte[o];
        const float gpre = in * (j ? isc1 : isc0) + (j ? ish1 : ish0);
        const float dgv = dg[o];
        const float dgpre = leaky_grad(gpre, dgv * u[s]);
        d_inte[o] = dgpre * (j ? isc1 : isc0);
        sums[j] += dgpre * in;
        sums[2 + j] += dgpre;
        du[s] = dgv * leaky(gpre);
      }
    }
    float dot = 0.f;
    if (softmax) {
#pragma unroll
      for (int s = 0; s < kMaxK; ++s)
        if (s < k) dot += u[s] * du[s];
    }
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) {
        const float da = softmax ? u[s] * (du[s] - dot) : du[s];
        const float dpre = leaky_grad(upre[s], da);
        sums[4] += dpre * v[s];
        sums[5] += dpre;
        const float dvs = dpre * sc;
        sums[6] += dvs;
        dv[((size_t)p * k + s) * two_fin + c] = dvs;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kSums; ++m) red[pl][m][cl] = sums[m];
  __syncthreads();
  if (pl == 0 && live_c) {
    float* o = scratch + (size_t)blockIdx.y * kSums * two_fin;
#pragma unroll
    for (int m = 0; m < kSums; ++m) {
      float s = 0.f;
      for (int q = 0; q < kSubP; ++q) s += red[q][m][cl];
      o[(size_t)m * two_fin + c] = s;
    }
  }
}

constexpr int kPlainRows = 64;  // rows (point, window) per plain-stage block

// plain stage: d_inte = LeakyReLU'(inte*isc + ish) * dg * isc, one thread per
// (row chunk, channel), the chunk's sums of d_isc and d_ish to scratch
__global__ void plain_gate_bwd_kernel(const float* __restrict__ inte,
                                      const float* __restrict__ isc,
                                      const float* __restrict__ ish,
                                      const float* __restrict__ dg,
                                      long long rows, int four_fin,
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
    const float in = inte[o];
    const float dgpre = leaky_grad(in * a + b, dg[o]);
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

// Forward operands: inte (rows, k/2*4Fin), h (rows, k*64) or null (plain
// stage: w2k..t2, w2k_t, d_h, d_w2k, dv ignored), isc/ish (4Fin), w2k (64, 2Fin),
// w2k_t (2Fin, 64), w2b/s2/t2 (2Fin), wi_t (2F, k/2*4Fin); dy (rows, 2F).
// Outputs: d_inte like inte, d_h like h, d_w2k (64, 2Fin), d_wi
// (k/2*4Fin, 2F), d_bias (2F), sums: gated (7, 2Fin) = [d_isc (4Fin) | d_ish
// (4Fin) | d_s2 | d_t2 | d_w2b], plain (2, 4Fin) = [d_isc | d_ish].
// Scratch: g (like inte), dv (rows*k, 2Fin), tn_scratch (the larger split
// partials of d_wi and d_w2k), sum_scratch (the larger per-block sums),
// colsum (ceil(rows/256), 2F).
int pdgn_bilateral_tail_bwd(
    const float* inte, const float* h, const float* isc, const float* ish,
    const float* w2k, const float* w2k_t, const float* w2b, const float* s2,
    const float* t2, const float* wi_t, const float* dy, int rows, int k,
    int two_fin, int two_f, int softmax, float* d_inte, float* d_h,
    float* d_w2k, float* d_wi, float* d_bias, float* sums, float* g,
    float* dv, float* tn_scratch, float* sum_scratch, float* colsum,
    cudaStream_t stream) {
  const int hk = k / 2;
  const int four_fin = 2 * two_fin;
  const int K = hk * four_fin;

  // 1.-2. recompute g, d_wi = g^T dy, then dg = dy wi^T into g's buffer
  cudaError_t err = launch_gate(inte, h, isc, ish, w2k, w2b, s2, t2, rows, k,
                                two_fin, softmax, g, stream);
  if (err != cudaSuccess) return (int)err;
  gemm_tn(PlainA{g, K}, PlainA{dy, two_f}, (long long)rows, K, two_f,
          tn_scratch, d_wi, stream);
  PDGN_CHECK_LAUNCH();
  float* dg = g;
  gemm(PlainA{dy, two_f}, wi_t, rows, two_f, K,
       Epilogue{dg, nullptr, nullptr, 0, K}, nullptr, stream);
  PDGN_CHECK_LAUNCH();
  const int nchunk = (rows + 255) / 256;
  chunk_colsum(PlainA{dy, two_f}, (long long)rows, two_f, 256, colsum, stream);
  column_reduce(colsum, nchunk, two_f, d_bias, stream);
  PDGN_CHECK_LAUNCH();

  // 3.-4. through the gate
  if (h != nullptr) {
    if (k > kMaxK) return (int)cudaErrorInvalidValue;
    const int nblk = (rows + kBlockP - 1) / kBlockP;
    dim3 grid((two_fin + kTC - 1) / kTC, nblk);
    gate_bwd_kernel<<<grid, 256, 0, stream>>>(inte, h, isc, ish, w2k, w2b, s2,
                                              t2, dg, rows, k, two_fin,
                                              softmax, d_inte, dv, sum_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(sum_scratch, nblk, kSums * two_fin, sums, stream);
    PDGN_CHECK_LAUNCH();
    const int hrows = rows * k;
    gemm(PlainA{dv, two_fin}, w2k_t, hrows, two_fin, kHid,
         Epilogue{d_h, nullptr, nullptr, 0, kHid}, nullptr, stream);
    PDGN_CHECK_LAUNCH();
    gemm_tn(PlainA{h, kHid}, PlainA{dv, two_fin}, (long long)hrows, kHid,
            two_fin, tn_scratch, d_w2k, stream);
    PDGN_CHECK_LAUNCH();
  } else {
    const long long prow = (long long)rows * hk;
    const int nblk = (int)((prow + kPlainRows - 1) / kPlainRows);
    dim3 grid((four_fin + 127) / 128, nblk);
    plain_gate_bwd_kernel<<<grid, 128, 0, stream>>>(inte, isc, ish, dg, prow,
                                                    four_fin, d_inte,
                                                    sum_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(sum_scratch, nblk, 2 * four_fin, sums, stream);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

}  // extern "C"
