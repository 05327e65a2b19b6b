// The gate of the edge-conv stage tail, shared by the forward
// (bilateral_tail.cu) and the backward (bilateral_tail_bwd.cu):
//   gated: g = LeakyReLU(inte*isc + ish)
//            * softmax_slots(LeakyReLU((h@w2k + w2b)*s2 + t2))
//   plain: g = LeakyReLU(inte*isc + ish)
// (rows, ldg), slot-major: slot s, channel c < 2Fin sits at column
// s*2Fin + c, which is the block channel (s%2)*2Fin + c of window block
// s/2; columns [k/2*4Fin, ldg) are zero.
//
// gate_tc_kernel: a block owns 64 channels of a 16-point tile, a warp one n8
// column of them; the slot logits U_s = h_s @ w2k are m16n8k8 products
// (3xTF32) whose B fragments (w2k, split once) stay in registers and whose
// A fragments come from the tile's h rows, staged in shared memory together
// with the tile's inte channels (one cp.async group; two blocks an SM).
// Every slot's fragment sits at the same (point, channel) positions of the
// same thread, so the softmax over the slots is thread-local: max, sum in
// ascending slot order, one reciprocal, then the gate
// LeakyReLU(inte*isc + ish) * weight. k <= 16 keeps the k logits in
// registers (KR = 10 or 16 of them); wider k (up to 126) takes a two-pass
// online softmax over chunks of 16 staged slots and recomputes each logit.
// The backward's gate pass (bilateral_tail_bwd.cu) takes the same tile,
// fragments, staging and logit code (GateThread, stage_tile, slot_conv,
// slot_logit, online_softmax), so the g it writes is this kernel's bit for
// bit. plain_gate_kernel is the plain stage's elementwise gate. A third
// user: the bf16 gated tail's fused kernel (bilateral_tail.cu,
// tail_bf16_kernel), whose producers take GateThreadT<bf16>'s logits from
// the same fragments laid out fragment-major (logits_frag: the same mma
// inputs in the same ks order), the softmax in gate_tc_kernel's order and
// gate_value, and store g straight into the merge's A tiles.
//
// Both gates are templates over the storage type T of inte, h and g.
// launch_gate serves the fp32 forward only; the bf16 code (the plain bf16
// stage's plain_gate_kernel, GateThreadT<bf16> in the fused kernel and, at
// its own rounding points, in the backward's bf16 gate pass) keeps the
// TPU kernels' (bilateral_tail.py:104-111, :123-130): the slot logits
// from bf16 h and w2k (exact in TF32: one pass a product,
// fp32 accumulation), BN fold, LeakyReLU and softmax in fp32, then the
// weight w, the gate's first factor gi and their product each rounded to
// bf16. Their h rows are 16-bit: the row stride pads 8 elements (16 bytes,
// 4 words: rows g at 4g words, the fragment's t within 2), and a channel
// array whose 2Fin is no multiple of 8 is staged by plain loads.
#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"

#include <math.h>

namespace {

constexpr int kGateP = 16;       // points a tile: the mma's m16
constexpr int kGateWarps = 8;    // a warp an n8 column of channels
constexpr int kGateC = 8 * kGateWarps;
constexpr int kHidden = 64;      // conv_all2 input width (8 k8 steps)
constexpr int kGateChunk = 16;   // slots staged at once
constexpr int kGateMaxK = 126;

// elements of T a 16-byte granule
template <class T>
constexpr int kGran = 16 / (int)sizeof(T);

// a non-deduced parameter type (nullptr arguments)
template <class T>
struct Same {
  using type = T;
};

// the copy of one granule of a channel array (column s*2Fin + c of a row of
// src): 16 bytes, or, when 2Fin is no multiple of a granule, 4-byte copies
// (fp32) or plain loads (bf16); channels past 2Fin and rows past the end
// (ok false) zero-filled
template <class T>
__device__ __forceinline__ void stage_channels(T* dst, const T* src,
                                               const T* base, bool ok,
                                               int cc, int two_fin) {
  constexpr int V = kGran<T>;
  if (two_fin % V == 0) {
    const bool in = ok && cc < two_fin;
    cp_async16(dst, in ? src : base, in ? 16 : 0);
  } else if constexpr (V == 4) {
    for (int v = 0; v < 4; ++v) {
      const bool in = ok && cc + v < two_fin;
      cp_async4(dst + v, in ? src + v : base, in ? 4 : 0);
    }
  } else {
    for (int v = 0; v < V; ++v) {
      const bool in = ok && cc + v < two_fin;
      dst[v] = in ? src[v] : T(0.f);
    }
  }
}

// issue the copies of the h rows of slots [s0, s0 + ns) of points [p0, p0
// + 16) into sh (row stride hl elements) and, with si, of the block's 64
// inte channels c0.. of those slots into si (row stride hl, 64 a slot), and
// with sd, the same channels of dg (rows of ldd floats) into sd, as one
// cp.async group; rows past the end and channels past 2Fin zero-filled.
template <class T>
__device__ __forceinline__ void stage_tile(
    T* sh, typename Same<T>::type* si, typename Same<T>::type* sd, int hl,
    const T* __restrict__ h, const T* __restrict__ inte,
    const typename Same<T>::type* __restrict__ dg, int ldd, int rows, int k,
    int two_fin, int c0, int p0, int s0, int ns) {
  constexpr int V = kGran<T>;
  constexpr int G = kHidden / V;     // granules a slot
  const int gran = ns * G;           // granules a row
  for (int e = threadIdx.x; e < kGateP * gran; e += blockDim.x) {
    const int r = e / gran, q = e - r * gran;
    const bool ok = p0 + r < rows;
    cp_async16(sh + r * hl + V * q,
               ok ? h + ((size_t)(p0 + r) * k + s0) * kHidden + V * q : h,
               ok ? 16 : 0);
    if (si == nullptr) continue;
    // granule q: slot s0 + q / G, channels c0 + V * (q % G) ..
    const int cc = c0 + V * (q % G);
    const size_t col = (size_t)(s0 + q / G) * two_fin + cc;
    stage_channels(si + r * hl + V * q,
                   inte + (size_t)(p0 + r) * k * two_fin + col, inte, ok, cc,
                   two_fin);
    if (sd != nullptr)
      stage_channels(sd + r * hl + V * q, dg + (size_t)(p0 + r) * ldd + col,
                     dg, ok, cc, two_fin);
  }
  cp_async_commit();
}

// conv_all2's output h_s @ w2k + w2b at this thread's four fragment
// positions (points g, g + 8; channels 2t, 2t + 1 of its warp's column);
// bf16 h and w2k are exact in TF32: one pass
template <class T>
__device__ __forceinline__ void slot_conv(const T* hs, int hl, int g,
                                          int t, const uint32_t bhi[8][2],
                                          const uint32_t blo[8][2],
                                          const float bias[2], float v[4]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < kHidden / 8; ++ks) {
    const T* a = hs + g * hl + ks * 8 + t;
    uint32_t ahi[4], alo[4];
    if constexpr (sizeof(T) == 2) {
      ahi[0] = __float_as_uint(to_f32(a[0]));
      ahi[1] = __float_as_uint(to_f32(a[8 * hl]));
      ahi[2] = __float_as_uint(to_f32(a[4]));
      ahi[3] = __float_as_uint(to_f32(a[8 * hl + 4]));
      mma_tf32(d, ahi, bhi[ks]);
    } else {
      split_tf32(a[0], ahi[0], alo[0]);
      split_tf32(a[8 * hl], ahi[1], alo[1]);
      split_tf32(a[4], ahi[2], alo[2]);
      split_tf32(a[8 * hl + 4], ahi[3], alo[3]);
      mma_tf32x3(d, ahi, alo, bhi[ks], blo[ks]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = d[q] + bias[q & 1];
}

// the bn_all2 fold of a conv_all2 output, and the slot logit
// LeakyReLU(v * s2 + t2)
__device__ __forceinline__ float slot_pre(float v, float sc, float sh) {
  return fmaf(v, sc, sh);
}
__device__ __forceinline__ float slot_logit(float v, float sc, float sh) {
  return leaky(slot_pre(v, sc, sh));
}

// the gate's first factor before its LeakyReLU: inte * isc + ish
__device__ __forceinline__ float gate_pre(float x, float a, float b) {
  return fmaf(x, a, b);
}

// one step of the online softmax over the slots: the running maximum m and
// normaliser z after logit u (slot s's weight is then expf(u_s - m) / z)
__device__ __forceinline__ void online_softmax(float& m, float& z, float u) {
  if (u > m) {
    z = fmaf(z, expf(m - u), 1.f);
    m = u;
  } else {
    z += expf(u - m);
  }
}

// What a thread of a gate block holds for the whole launch: w2k's fragments
// of its warp's column (b0 = w2k[ks*8 + t][n0 + g], b1 = w2k[ks*8 + t +
// 4][n0 + g]), split once (a bf16 w2k's low halves are 0), and per column q
// of its channel pair c + q: conv_all2's bias and folded BN, and inte's
// folded BN at block channel (slot parity)*2Fin + c + q. T: the storage
// type of w2k and h.
template <class T>
struct GateThreadT {
  uint32_t bhi[8][2], blo[8][2];
  float bias[2], sc[2], shf[2];
  float isc_p[2][2], ish_p[2][2];
  bool live[2];

  __device__ __forceinline__ void load(const float* __restrict__ isc,
                                       const float* __restrict__ ish,
                                       const T* __restrict__ w2k,
                                       const float* __restrict__ w2b,
                                       const float* __restrict__ s2,
                                       const float* __restrict__ t2, int c,
                                       int cb, int t, int two_fin) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float b0 =
          cb < two_fin ? to_f32(w2k[(size_t)(ks * 8 + t) * two_fin + cb])
                       : 0.f;
      const float b1 =
          cb < two_fin ? to_f32(w2k[(size_t)(ks * 8 + t + 4) * two_fin + cb])
                       : 0.f;
      split_tf32(b0, bhi[ks][0], blo[ks][0]);
      split_tf32(b1, bhi[ks][1], blo[ks][1]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      live[q] = c + q < two_fin;
      bias[q] = live[q] ? w2b[c + q] : 0.f;
      sc[q] = live[q] ? s2[c + q] : 0.f;
      shf[q] = live[q] ? t2[c + q] : 0.f;
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        isc_p[par][q] = live[q] ? isc[par * two_fin + c + q] : 0.f;
        ish_p[par][q] = live[q] ? ish[par * two_fin + c + q] : 0.f;
      }
    }
  }

  // inte's folded BN of slot s at column q (a select, not an index: s may
  // be known only at run time)
  __device__ __forceinline__ float isc(int s, int q) const {
    return s & 1 ? isc_p[1][q] : isc_p[0][q];
  }
  __device__ __forceinline__ float ish(int s, int q) const {
    return s & 1 ? ish_p[1][q] : ish_p[0][q];
  }

  // the slot logits at the thread's four positions
  __device__ __forceinline__ void logits(const T* hs, int hl, int g, int t,
                                         float u[4]) const {
    float v[4];
    slot_conv(hs, hl, g, t, bhi, blo, bias, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] = slot_logit(v[q], sc[q & 1], shf[q & 1]);
  }

  // the same logits from bf16 A fragments laid out fragment-major: the k8
  // step ks of lane l holds A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] in
  // frag[ks * 32 + l] (one 8-byte load a product; the same mma inputs in
  // the same ks order as slot_conv's bf16 branch, so the same bits)
  __device__ __forceinline__ void logits_frag(const uint2* frag, int lane,
                                              float u[4]) const {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kHidden / 8; ++ks) {
      const uint2 w = frag[ks * 32 + lane];
      const uint32_t a[4] = {w.x << 16, w.x & 0xffff0000u, w.y << 16,
                             w.y & 0xffff0000u};
      mma_tf32(d, a, bhi[ks]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      u[q] = slot_logit(d[q] + bias[q & 1], sc[q & 1], shf[q & 1]);
  }
};
using GateThread = GateThreadT<float>;

// the gate's value from its first factor gi (after the LeakyReLU) and the
// slot weight w: fp32 gi * w, or, bf16, both factors and the product
// rounded (the TPU kernel's .astype(dt) points)
template <class T>
__device__ __forceinline__ float gate_value(float gi, float w) {
  if constexpr (sizeof(T) == 2)
    return round_as<T>(round_as<T>(gi) * round_as<T>(w));
  return gi * w;
}

// KR > 0: k <= KR logits a thread in registers; KR == 0: any even k <=
// kGateMaxK, two passes. Dynamic shared memory: 2 x 16 rows of hl floats
// (h, then the tile's inte channels, staged together so that their loads
// are in flight at once); two blocks an SM overlap one's loads with the
// other's products.
template <int KR, class T>
__global__ void __launch_bounds__(32 * kGateWarps, 2)
gate_tc_kernel(const T* __restrict__ inte, const T* __restrict__ h,
               const float* __restrict__ isc, const float* __restrict__ ish,
               const T* __restrict__ w2k, const float* __restrict__ w2b,
               const float* __restrict__ s2, const float* __restrict__ t2,
               int rows, int k, int two_fin, int ldg, int softmax,
               T* __restrict__ g_out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = k < kGateChunk ? k : kGateChunk;
  // row stride: a-fragment reads hit 32 banks (a 16-byte pad)
  const int hl = kc * kHidden + kGran<T>;
  const int c0 = blockIdx.x * kGateC;
  const int cl = warp * 8 + 2 * t;  // the pair's first channel in the block
  const int c = c0 + cl;            // and c + 1
  GateThreadT<T> th;
  th.load(isc, ish, w2k, w2b, s2, t2, c, c0 + warp * 8 + g, t, two_fin);

  // gate slot s (its inte staged in si at sl) at the thread's positions
  // with softmax weights w[4]
  auto write = [&](const T* si, int p0, int s, int sl, const float w[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      if (p0 + r >= rows) continue;
      const T* x = si + r * hl + sl * kHidden + cl;
      T* o = g_out + (size_t)(p0 + r) * ldg + s * two_fin + c;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float a = th.isc(s, q), b = th.ish(s, q);
        if (th.live[q])
          store_as(o + q, gate_value<T>(leaky(gate_pre(to_f32(x[q]), a, b)),
                                        w[2 * half + q]));
      }
    }
  };

  const int tiles = (rows + kGateP - 1) / kGateP;
  T* sh = reinterpret_cast<T*>(smem);
  T* si = sh + kGateP * hl;
  if constexpr (KR > 0) {
    for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
      const int p0 = tile * kGateP;
      __syncthreads();  // the previous tile's rows are read
      stage_tile(sh, si, nullptr, hl, h, inte, nullptr, 0, rows, k, two_fin,
                 c0, p0, 0, k);
      cp_async_wait<0>();
      __syncthreads();
      float u[KR][4];
#pragma unroll
      for (int s = 0; s < KR; ++s)
        if (s < k) th.logits(sh + s * kHidden, hl, g, t, u[s]);
      if (softmax) {
        // the backward's gate pass (gate_bwd_tc_kernel) takes these
        // weights as expf(u - m) * rz with m, z and rz formed in this order
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float m = u[0][q];
#pragma unroll
          for (int s = 1; s < KR; ++s)
            if (s < k) m = fmaxf(m, u[s][q]);
          float z = 0.f;
#pragma unroll
          for (int s = 0; s < KR; ++s)
            if (s < k) {
              u[s][q] = expf(u[s][q] - m);
              z += u[s][q];
            }
          const float rz = 1.f / z;
#pragma unroll
          for (int s = 0; s < KR; ++s)
            if (s < k) u[s][q] *= rz;
        }
      }
#pragma unroll
      for (int s = 0; s < KR; ++s)
        if (s < k) write(si, p0, s, s, u[s]);
    }
  } else {
    for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
      const int p0 = tile * kGateP;
      // pass 1: the running maximum m and normaliser z over the slots
      float m[4], z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m[q] = -INFINITY;
        z[q] = 0.f;
      }
      for (int s0 = 0; s0 < k && softmax; s0 += kGateChunk) {
        const int ns = k - s0 < kGateChunk ? k - s0 : kGateChunk;
        __syncthreads();
        stage_tile(sh, nullptr, nullptr, hl, h, inte, nullptr, 0, rows, k,
                   two_fin, c0, p0, s0, ns);
        cp_async_wait<0>();
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
          float u[4];
          th.logits(sh + s * kHidden, hl, g, t, u);
#pragma unroll
          for (int q = 0; q < 4; ++q) online_softmax(m[q], z[q], u[q]);
        }
      }
      // pass 2: recompute each logit, weight it, gate
      for (int s0 = 0; s0 < k; s0 += kGateChunk) {
        const int ns = k - s0 < kGateChunk ? k - s0 : kGateChunk;
        __syncthreads();
        stage_tile(sh, si, nullptr, hl, h, inte, nullptr, 0, rows, k,
                   two_fin, c0, p0, s0, ns);
        cp_async_wait<0>();
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
          float u[4];
          th.logits(sh + s * kHidden, hl, g, t, u);
          if (softmax) {
#pragma unroll
            for (int q = 0; q < 4; ++q) u[q] = expf(u[q] - m[q]) / z[q];
          }
          write(si, p0, s0 + s, s, u);
        }
      }
    }
  }
}

// g[p, c] = LeakyReLU(inte[p, c] * isc[c % 4Fin] + ish[c % 4Fin]) for c < K,
// 0 in the pad columns [K, ldg) (stored as T: bf16 rounds)
template <class T>
__global__ void plain_gate_kernel(const T* __restrict__ inte,
                                  const float* __restrict__ isc,
                                  const float* __restrict__ ish, long long rows,
                                  int K, int ldg, int four_fin,
                                  T* __restrict__ g) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * ldg) return;
  const long long p = e / ldg;
  const int col = (int)(e - p * ldg);
  float v = 0.f;
  if (col < K) {
    const int ch = col % four_fin;
    v = leaky(gate_pre(to_f32(inte[p * K + col]), isc[ch], ish[ch]));
  }
  store_as(g + e, v);
}

template <int KR, class T>
cudaError_t launch_gate_tc(int k, const T* inte, const T* h,
                           const float* isc, const float* ish, const T* w2k,
                           const float* w2b, const float* s2, const float* t2,
                           int rows, int two_fin, int ldg, int softmax, T* g,
                           cudaStream_t stream) {
  const int kc = k < kGateChunk ? k : kGateChunk;
  const int smem =
      2 * kGateP * (kc * kHidden + kGran<T>) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gate_tc_kernel<KR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles = (rows + kGateP - 1) / kGateP;
  dim3 grid((two_fin + kGateC - 1) / kGateC, tiles < 65535 ? tiles : 65535);
  gate_tc_kernel<KR, T><<<grid, 32 * kGateWarps, smem, stream>>>(
      inte, h, isc, ish, w2k, w2b, s2, t2, rows, k, two_fin, ldg, softmax, g);
  return cudaGetLastError();
}

// g (rows, ldg) of the gated (h non-null) or the plain stage; ldg >= k/2 *
// 4Fin. h and inte 16-byte aligned (the gated stage's copies). T: the
// storage type of inte, h, w2k and g.
template <class T>
inline cudaError_t launch_gate(const T* inte, const T* h, const float* isc,
                               const float* ish, const T* w2k,
                               const float* w2b, const float* s2,
                               const float* t2, int rows, int k, int four_fin,
                               int ldg, int softmax, T* g,
                               cudaStream_t stream) {
  const int K = (k / 2) * four_fin;
  if (h == nullptr) {
    const long long total = (long long)rows * ldg;
    plain_gate_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                           stream>>>(inte, isc, ish, rows, K, ldg, four_fin,
                                     g);
    return cudaGetLastError();
  }
  if (four_fin % 2 || k > kGateMaxK) return cudaErrorInvalidValue;
  const int two_fin = four_fin / 2;
  cudaError_t err;
  if (k <= 10)
    err = launch_gate_tc<10>(k, inte, h, isc, ish, w2k, w2b, s2, t2, rows,
                             two_fin, ldg, softmax, g, stream);
  else if (k <= kGateChunk)
    err = launch_gate_tc<kGateChunk>(k, inte, h, isc, ish, w2k, w2b, s2, t2,
                                     rows, two_fin, ldg, softmax, g, stream);
  else
    err = launch_gate_tc<0>(k, inte, h, isc, ish, w2k, w2b, s2, t2, rows,
                            two_fin, ldg, softmax, g, stream);
  if (err == cudaSuccess && ldg > K)  // pad columns meet wi's zero rows
    err = cudaMemset2DAsync(g + K, sizeof(T) * ldg, 0, sizeof(T) * (ldg - K),
                            rows, stream);
  return err;
}

}  // namespace
