// The gate of the edge-conv stage tail, shared by the forward
// (bilateral_tail.cu) and the backward (bilateral_tail_bwd.cu), which
// recomputes it instead of keeping it from the forward.
//   gated: g = LeakyReLU(inte*isc + ish)
//            * softmax_slots(LeakyReLU((h@w2k + w2b)*s2 + t2))
//   plain: g = LeakyReLU(inte*isc + ish)
// in the block channel layout (B, N, k/2 * 4Fin).
//
// k <= 16 (kMaxK): gate_kernel keeps a thread's k slot values in registers.
// Larger even k (k + 1 <= 128, the graph's longest list): gate_wide_kernel
// stages the k * 64 h values of its points in dynamic shared memory and
// takes a two-pass online softmax, recomputing each slot's conv_all2 (the
// same fmaf chain) instead of keeping k values a thread.
#pragma once

#include "common.cuh"

#include <math.h>

namespace {

constexpr int kHid = 64;      // conv_all2 input width
constexpr int kTC = 64;       // conv_all2 output channels per block
constexpr int kSubP = 4;      // points per shared-memory sub-tile
constexpr int kBlockP = 32;   // points per block
constexpr int kMaxK = 16;
constexpr int kMaxWideK = 126;

// LeakyReLU((h_s @ w2k[:, c] + w2b) * s2 + t2) of slot s: hp the point's
// staged h row, sw the block's (kHid, kTC) weight tile
__device__ __forceinline__ float slot_logit(const float* hp, const float* sw,
                                            int s, int cl, float bias,
                                            float sc, float sh) {
  float a = 0.f;
#pragma unroll 16
  for (int hh = 0; hh < kHid; ++hh)
    a = fmaf(hp[s * kHid + hh], sw[hh * kTC + cl], a);
  return leaky((a + bias) * sc + sh);
}

// the softmax's running maximum m and normaliser z over the k slots in one
// pass: slot s's weight is then expf(u_s - m) / z
__device__ __forceinline__ void online_softmax(const float* hp,
                                               const float* sw, int k, int cl,
                                               float bias, float sc, float sh,
                                               float& m, float& z) {
  m = -INFINITY;
  z = 0.f;
  for (int s = 0; s < k; ++s) {
    const float u = slot_logit(hp, sw, s, cl, bias, sc, sh);
    if (u > m) {
      z = z * expf(m - u) + 1.f;
      m = u;
    } else {
      z += expf(u - m);
    }
  }
}

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

// k > kMaxK: shw (dynamic) holds kSubP * k * kHid floats of h
__global__ void __launch_bounds__(256)
gate_wide_kernel(const float* __restrict__ inte, const float* __restrict__ h,
                 const float* __restrict__ isc, const float* __restrict__ ish,
                 const float* __restrict__ w2k, const float* __restrict__ w2b,
                 const float* __restrict__ s2, const float* __restrict__ t2,
                 int rows, int k, int two_fin, int softmax,
                 float* __restrict__ g) {
  __shared__ float sw[kHid * kTC];
  extern __shared__ float shw[];

  const int tid = threadIdx.x;
  const int cl = tid % kTC;
  const int pl = tid / kTC;
  const int c0 = blockIdx.x * kTC;
  const int c = c0 + cl;
  const int hk = k / 2;
  const int four_fin = 2 * two_fin;

  for (int e = tid; e < kHid * kTC; e += 256) {
    int hh = e / kTC, cc = e % kTC;
    sw[e] = (c0 + cc < two_fin) ? w2k[(size_t)hh * two_fin + c0 + cc] : 0.f;
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
      shw[e] = (p0 + pp < p_end) ? h[(size_t)(p0 + pp) * width + rem] : 0.f;
    }
    __syncthreads();
    const int p = p0 + pl;
    if (p >= p_end || !live_c) continue;
    const float* hp = shw + pl * width;
    float m = 0.f, z = 1.f;
    if (softmax) online_softmax(hp, sw, k, cl, bias, sc, sh, m, z);
    const size_t base = (size_t)p * hk * four_fin;
    for (int s = 0; s < k; ++s) {
      const float u = slot_logit(hp, sw, s, cl, bias, sc, sh);
      const float w = softmax ? expf(u - m) / z : u;
      int ch = (s % 2) * two_fin + c;
      size_t o = base + (size_t)(s / 2) * four_fin + ch;
      g[o] = leaky(inte[o] * isc[ch] + ish[ch]) * w;
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

// g (rows, k/2*4Fin) for the gated (h non-null) or the plain stage
inline cudaError_t launch_gate(const float* inte, const float* h,
                               const float* isc, const float* ish,
                               const float* w2k, const float* w2b,
                               const float* s2, const float* t2, int rows,
                               int k, int two_fin, int softmax, float* g,
                               cudaStream_t stream) {
  if (h != nullptr) {
    if (k > kMaxWideK) return cudaErrorInvalidValue;
    dim3 grid((two_fin + kTC - 1) / kTC, (rows + kBlockP - 1) / kBlockP);
    if (k <= kMaxK) {
      gate_kernel<<<grid, 256, 0, stream>>>(inte, h, isc, ish, w2k, w2b, s2,
                                            t2, rows, k, two_fin, softmax, g);
    } else {
      const int smem = kSubP * k * kHid * (int)sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(
          gate_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
      gate_wide_kernel<<<grid, 256, smem, stream>>>(inte, h, isc, ish, w2k,
                                                    w2b, s2, t2, rows, k,
                                                    two_fin, softmax, g);
    }
  } else {
    long long total = (long long)rows * (k / 2) * 2 * two_fin;
    plain_gate_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        inte, isc, ish, total, 2 * two_fin, g);
  }
  return cudaGetLastError();
}

}  // namespace
