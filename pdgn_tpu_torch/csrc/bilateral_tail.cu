// Edge-conv stage tail for Hopper (sm_90a).
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/bilateral_tail.py::_gated_kernel
// (stages 2-4) and ::_plain_kernel (stage 1), launcher _pallas_tail:
//   gated: y = partial + (LeakyReLU(inte*isc + ish)
//                         * softmax_slots(LeakyReLU((h@w2k + w2b)*s2 + t2))) @ wi
//              + bias
//   plain: y = partial + LeakyReLU(inte*isc + ish) @ wi + bias
//
// What bounds it on the H100: operations. At stage 4 one cloud costs
// ~5.4 GFLOP of merge GEMM plus ~0.7 GFLOP of conv_all2 against ~40 MB of
// reads, far above the fp32 balance point.
//
// The simple design, two launches:
//   1. gate_kernel (or plain_gate_kernel) writes the gate tensor g
//      (B, N, k/2 * 4Fin) in block channel layout. A thread owns one
//      (point, conv_all2 channel), runs the 64-wide conv_all2 dot for all k
//      slots from shared memory, applies the folded BN and LeakyReLU, the
//      softmax over the slots, and gates the BN+LeakyReLU of inte.
//   2. gemm_kernel computes y = (partial + g @ wi) + bias.
// Unlike the TPU kernel, g round-trips through device memory; removing that
// round trip is the first item of the tail's redesign.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kHid = 64;      // conv_all2 input width
constexpr int kTC = 64;       // conv_all2 output channels per block
constexpr int kSubP = 4;      // points per shared-memory sub-tile
constexpr int kBlockP = 32;   // points per block
constexpr int kMaxK = 16;

__global__ void __launch_bounds__(256)
gate_kernel(const float* __restrict__ inte, const float* __restrict__ h,
            const float* __restrict__ isc, const float* __restrict__ ish,
            const float* __restrict__ w2k, const float* __restrict__ w2b,
            const float* __restrict__ s2, const float* __restrict__ t2,
            int rows, int k, int two_fin, int softmax, float* __restrict__ g) {
  __shared__ float sw[kHid][kTC];
  __shared__ float shh[kSubP][kMaxK * kHid];

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

    float u[kMaxK];
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) {
        float a = 0.f;
#pragma unroll 16
        for (int hh = 0; hh < kHid; ++hh)
          a = fmaf(shh[pl][s * kHid + hh], sw[hh][cl], a);
        u[s] = leaky((a + bias) * sc + sh);
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
        int ch = (s % 2) * two_fin + c;           // block channel in 4Fin
        size_t o = base + (size_t)(s / 2) * four_fin + ch;
        g[o] = leaky(inte[o] * isc[ch] + ish[ch]) * u[s];
      }
    }
  }
}

__global__ void plain_gate_kernel(const float* __restrict__ inte,
                                  const float* __restrict__ isc,
                                  const float* __restrict__ ish,
                                  long long total, int four_fin,
                                  float* __restrict__ g) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int ch = (int)(e % four_fin);
  g[e] = leaky(inte[e] * isc[ch] + ish[ch]);
}

}  // namespace

extern "C" {

// partial (rows, 2F); inte (rows, k/2*4Fin); h (rows, k*64) or null for the
// plain stage; wi (k/2*4Fin, 2F); g scratch shaped like inte; y (rows, 2F).
int pdgn_bilateral_tail(const float* partial, const float* inte,
                        const float* h, const float* isc, const float* ish,
                        const float* w2k, const float* w2b, const float* s2,
                        const float* t2, const float* wi, const float* bias,
                        int rows, int k, int two_fin, int two_f, int softmax,
                        float* g, float* y, cudaStream_t stream) {
  const int hk = k / 2;
  const int four_fin = 2 * two_fin;
  const int K = hk * four_fin;
  if (h != nullptr) {
    if (k > kMaxK) return (int)cudaErrorInvalidValue;
    dim3 grid((two_fin + kTC - 1) / kTC, (rows + kBlockP - 1) / kBlockP);
    gate_kernel<<<grid, 256, 0, stream>>>(inte, h, isc, ish, w2k, w2b, s2, t2,
                                          rows, k, two_fin, softmax, g);
  } else {
    long long total = (long long)rows * K;
    plain_gate_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        inte, isc, ish, total, four_fin, g);
  }
  PDGN_CHECK_LAUNCH();
  PlainA a{g, K};
  Epilogue epi{y, bias, partial, 0, two_f};
  gemm(a, wi, rows, K, two_f, epi, nullptr, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
