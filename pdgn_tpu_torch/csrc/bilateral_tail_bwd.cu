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
//
// The bf16 instances (bf16 inte, h, w2k, wi and dy, the backward of
// --compute_dtype bfloat16) keep the TPU kernels' rounding points
// (_gated_bwd_kernel, _plain_bwd_kernel), which are not the forward's: dg
// = dy wi^T accumulates in fp32 and stays fp32; the gate is recomputed from
// bf16 h and w2k (exact products, fp32 sums) and its slot weight w stays
// fp32; the d_wi operand is (gi * w) rounded once (plain: gi rounded); the
// slot logit's cotangent dpre is rounded to bf16 (dv) before d_h = dv w2k^T
// and d_w2k = h^T dv; d_inte and d_h are stored in bf16, the weight
// gradients and the sums in fp32. Every LeakyReLU branch is taken as the
// TPU kernel takes it (input >= 0), the slot logit's from the fp32
// conv_all2 output as the plain version takes it (no double
// recomputation), and the elementwise products are rounded one operation
// at a time (no contraction), as the plain version evaluates them.
//   The plain stage, and the gated stage at k > 16 (the --num_k 36
// generator's k = 18 and wider), keep the fp32 design on the core's bf16
// instance (pdgn_bilateral_tail_bwd_bf16: dg staged in fp32 beside the
// bf16 h and inte, gate_bwd_tc_kernel<KR, bf16>).
//   The gated stage at k <= 16 (pdgn_bilateral_tail_gated_bwd_bf16) is
// Hopper's own, as the TPU kernel forms dg per row tile and consumes it at
// once (:179, :185-216): tail_bwd_bf16_kernel (below) makes dg on wgmma a
// block of channels at a time, all k slots of a channel in one thread's
// accumulators, and walks the gate in registers, so dg is never written;
// the weight gradients d_wi = g^T dy and d_w2k = h^T dv (the TPU kernel's
// g_b^T dout_b and h_b^T dpre_b) run on hopper.cuh's MN-major
// product_bf16_kernel, split over the rows, the partials added in order;
// d_h = dv w2k^T runs on its K-major instance, rounded to bf16 at the
// store. At stage 4, B=35 the fused launch moves ~1.5 GB of HBM (inte in;
// g, d_inte, dv out) where the core's chain moves ~4.4 GB (dg written and
// read in fp32).
#include "hopper.cuh"
#include "tail_gate.cuh"
#include "tf32x3_gemm.cuh"

namespace {

constexpr int kSums = 7;  // isc j0 | isc j1 | ish j0 | ish j1 | s2 | t2 | w2b

// a bf16 (rows, ld) matrix read one element at a time as fp32
struct PlainBf16 {
  const __nv_bfloat16* a;
  int ld;
  __device__ __forceinline__ float load(long long row, int kk) const {
    return __bfloat162float(a[(size_t)row * ld + kk]);
  }
};

// LeakyReLU's derivative times d, as PyTorch takes it (0.01 at pre == 0)
__device__ __forceinline__ float leaky_grad(float pre, float d) {
  return pre > 0.f ? d : 0.01f * d;
}
// as the TPU kernels take it (1 at pre == 0): the bf16 instance
__device__ __forceinline__ float leaky_grad_ge(float pre, float d) {
  return pre >= 0.f ? d : __fmul_rn(0.01f, d);
}
// the bf16 instance's folds, a product and a sum each rounded
__device__ __forceinline__ float gate_pre_rn(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}
__device__ __forceinline__ float slot_pre_rn(float v, float sc, float sh) {
  return __fadd_rn(__fmul_rn(v, sc), sh);
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
//
// T = bf16 (the bf16 instance): h, inte, g, d_inte and dv in bf16, dg fp32
// staged in its own array (rows of hd = kc*64 + 4 floats); the branches,
// the weights and the roundings of the module comment; kink unused.
template <int KR, class T>
__global__ void __launch_bounds__(32 * kGateWarps, 1)
gate_bwd_tc_kernel(const T* __restrict__ inte,
                   const T* __restrict__ h, const float* __restrict__ dg,
                   const float* __restrict__ isc,
                   const float* __restrict__ ish,
                   const T* __restrict__ w2k,
                   const float* __restrict__ w2b,
                   const float* __restrict__ s2,
                   const float* __restrict__ t2,
                   const float* __restrict__ kink, int rows, int k,
                   int two_fin, int ldg, int ldv, int softmax,
                   T* __restrict__ g_out, T* __restrict__ d_inte,
                   T* __restrict__ dv, float* __restrict__ scratch) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = k < kGateChunk ? k : kGateChunk;
  const int hl = kc * kHidden + kGran<T>;
  const int hd = kc * kHidden + 4;  // the bf16 instance's fp32 dg rows
  const int c0 = blockIdx.x * kGateC;
  const int cl = warp * 8 + 2 * t;
  const int c = c0 + cl;
  const size_t K = (size_t)k * two_fin;  // inte's row: k/2 * 4Fin
  GateThreadT<T> th;
  th.load(isc, ish, w2k, w2b, s2, t2, c, c0 + warp * 8 + g, t, two_fin);
  T* sh = reinterpret_cast<T*>(smem);
  T* si = sh + kGateP * hl;
  // fp32: dg beside h and inte (stage_tile); bf16: its own fp32 array
  float* sd = kBf16 ? reinterpret_cast<float*>(si + kGateP * hl)
                    : reinterpret_cast<float*>(si) + kGateP * hl;
  const int sdl = kBf16 ? hd : hl;
  float kq[2] = {-1.f, -1.f};
  if constexpr (!kBf16) {
    kq[0] = th.live[0] ? kink[c] : -1.f;
    kq[1] = th.live[1] ? kink[c + 1] : -1.f;
  }
  // the bf16 instance stages dg of slots [s0, s0 + ns) of the tile's
  // points (fp32 granules, in the same cp.async group as stage_tile's)
  auto stage_dg = [&](int p0, int s0, int ns) {
    if constexpr (kBf16) {
      const int gran = ns * (kHidden / 4);
      for (int e = threadIdx.x; e < kGateP * gran; e += blockDim.x) {
        const int r = e / gran, q = e - r * gran;
        const bool ok = p0 + r < rows;
        const int cc = c0 + 4 * (q % (kHidden / 4));
        const size_t col = (size_t)(s0 + q / (kHidden / 4)) * two_fin + cc;
        stage_channels(sd + r * hd + 4 * q, dg + (size_t)(p0 + r) * ldg + col,
                       dg, ok, cc, two_fin);
      }
    }
  };
  // the staging of a tile: fp32 dg in stage_tile's group, bf16 dg apart
  auto stage = [&](int p0, int s0, int ns, bool with_inte) {
    if constexpr (kBf16) {
      if (with_inte) stage_dg(p0, s0, ns);
      stage_tile(sh, with_inte ? si : nullptr, nullptr, hl, h, inte,
                 nullptr, 0, rows, k, two_fin, c0, p0, s0, ns);
    } else {
      stage_tile(sh, with_inte ? si : nullptr, with_inte ? sd : nullptr, hl,
                 h, inte, dg, ldg, rows, k, two_fin, c0, p0, s0, ns);
    }
  };

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
        const float x = to_f32(si[r * hl + sl * kHidden + cl + qq]);
        const float dgv = sd[r * sdl + sl * kHidden + cl + qq];
        const float a = th.isc(s, qq);
        if constexpr (kBf16) {
          const float w =
              weight(leaky(slot_pre_rn(v[q], th.sc[qq], th.shf[qq])), q);
          const float gpre = gate_pre_rn(x, a, th.ish(s, qq));
          const float lg = leaky(gpre);
          const float dgpre = leaky_grad_ge(gpre, __fmul_rn(dgv, w));
          sums[(s & 1)][qq] += __fmul_rn(dgpre, x);
          sums[2 + (s & 1)][qq] += dgpre;
          dot[q] += __fmul_rn(__fmul_rn(dgv, lg), w);
          if (row && th.live[qq]) {
            store_as(g_out + og + qq, __fmul_rn(lg, w));
            store_as(d_inte + o + qq, __fmul_rn(dgpre, a));
          }
        } else {
          const float w = weight(slot_logit(v[q], th.sc[qq], th.shf[qq]), q);
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
        const float x = to_f32(si[r * hl + sl * kHidden + cl + qq]);
        const float dgv = sd[r * sdl + sl * kHidden + cl + qq];
        if constexpr (kBf16) {
          const float upre = slot_pre_rn(v[q], th.sc[qq], th.shf[qq]);
          const float w = weight(leaky(upre), q);
          const float gpre = gate_pre_rn(x, th.isc(s, qq), th.ish(s, qq));
          const float du = __fmul_rn(dgv, leaky(gpre));
          const float da = softmax ? __fmul_rn(w, du - dot[q]) : du;
          const float dpre = leaky_grad_ge(upre, da);
          sums[4][qq] += __fmul_rn(dpre, v[q]);
          sums[5][qq] += dpre;
          out[qq] = __fmul_rn(dpre, th.sc[qq]);
          sums[6][qq] += out[qq];
        } else {
          const float upre = slot_pre(v[q], th.sc[qq], th.shf[qq]);
          const float w = weight(leaky(upre), q);
          const float gpre = gate_pre(x, th.isc(s, qq), th.ish(s, qq));
          const float du = dgv * leaky(gpre);
          const float da = softmax ? w * (du - dot[q]) : du;
          bool up = upre > 0.f;
          if (fabsf(upre) <= kq[qq])
            up = exact_pre_positive(
                reinterpret_cast<const float*>(sh) + r * hl + sl * kHidden,
                reinterpret_cast<const float*>(w2k), two_fin, c + qq,
                th.bias[qq], th.sc[qq], th.shf[qq]);
          const float dpre = up ? da : 0.01f * da;
          sums[4][qq] += dpre * v[q];
          sums[5][qq] += dpre;
          out[qq] = dpre * th.sc[qq];
          sums[6][qq] += out[qq];
        }
      }
      if (p0 + r < rows && c < ldv) {
        // c even, ldv a multiple of 4: the pair fits, aligned
        T* o = dv + ((size_t)(p0 + r) * k + s) * ldv + c;
        store_as(o, th.live[0] ? out[0] : 0.f);
        store_as(o + 1, th.live[1] ? out[1] : 0.f);
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
      stage(p0, 0, k, true);
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
          auto logit = [&](float vv) {
            if constexpr (kBf16) return leaky(slot_pre_rn(vv, sc, sf));
            return slot_logit(vv, sc, sf);
          };
          float mx = logit(v[0][q]);
#pragma unroll
          for (int s = 1; s < KR; ++s)
            if (s < k) mx = fmaxf(mx, logit(v[s][q]));
          float z = 0.f;
#pragma unroll
          for (int s = 0; s < KR; ++s)
            if (s < k) z += expf(logit(v[s][q]) - mx);
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
        stage(p0, s0, ns, false);
        cp_async_wait<0>();
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
          float u[4];
          if constexpr (kBf16) {
            slot_conv(sh + s * kHidden, hl, g, t, th.bhi, th.blo, th.bias, u);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              u[q] = leaky(slot_pre_rn(u[q], th.sc[q & 1], th.shf[q & 1]));
          } else {
            th.logits(sh + s * kHidden, hl, g, t, u);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) online_softmax(m[q], nz[q], u[q]);
        }
      }
      for (int pass = 0; pass < 2; ++pass) {
        for (int s0 = 0; s0 < k; s0 += kGateChunk) {
          const int ns = k - s0 < kGateChunk ? k - s0 : kGateChunk;
          __syncthreads();
          stage(p0, s0, ns, true);
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

template <int KR, class T>
cudaError_t launch_gate_bwd_tc(int k, const T* inte, const T* h,
                               const float* dg, const float* isc,
                               const float* ish, const T* w2k,
                               const float* w2b, const float* s2,
                               const float* t2, const float* kink, int rows,
                               int two_fin,
                               int ldg, int ldv, int softmax, T* g,
                               T* d_inte, T* dv, float* scratch,
                               cudaStream_t stream) {
  const int kc = k < kGateChunk ? k : kGateChunk;
  // h and inte in T, dg in fp32
  const int smem =
      2 * kGateP * (kc * kHidden + kGran<T>) * (int)sizeof(T) +
      kGateP * (kc * kHidden + 4) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gate_bwd_tc_kernel<KR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((two_fin + kGateC - 1) / kGateC, gate_bwd_blocks(rows));
  gate_bwd_tc_kernel<KR, T><<<grid, 32 * kGateWarps, smem, stream>>>(
      inte, h, dg, isc, ish, w2k, w2b, s2, t2, kink, rows, k, two_fin, ldg,
      ldv, softmax, g, d_inte, dv, scratch);
  return cudaGetLastError();
}

// the gate pass at k's register width
template <class T>
cudaError_t launch_gate_bwd(int k, const T* inte, const T* h,
                            const float* dg, const float* isc,
                            const float* ish, const T* w2k, const float* w2b,
                            const float* s2, const float* t2,
                            const float* kink, int rows, int two_fin,
                            int ldg, int ldv, int softmax, T* g, T* d_inte,
                            T* dv, float* scratch, cudaStream_t stream) {
  if (k <= 10)
    return launch_gate_bwd_tc<10>(k, inte, h, dg, isc, ish, w2k, w2b, s2, t2,
                                  kink, rows, two_fin, ldg, ldv, softmax, g,
                                  d_inte, dv, scratch, stream);
  if (k <= kGateChunk)
    return launch_gate_bwd_tc<kGateChunk>(k, inte, h, dg, isc, ish, w2k, w2b,
                                          s2, t2, kink, rows, two_fin, ldg,
                                          ldv, softmax, g, d_inte, dv,
                                          scratch, stream);
  return launch_gate_bwd_tc<0>(k, inte, h, dg, isc, ish, w2k, w2b, s2, t2,
                               kink, rows, two_fin, ldg, ldv, softmax, g,
                               d_inte, dv, scratch, stream);
}

constexpr int kPlainRows = 64;  // rows (point, window) per plain-stage block

// plain stage: g = LeakyReLU(inte*isc + ish) (the forward's) and d_inte =
// LeakyReLU'(inte*isc + ish) * dg * isc, one thread per (row chunk,
// channel), the chunk's sums of d_isc and d_ish to scratch. Row r is
// (point r / hk, window r % hk); g and dg have ldg columns. T = bf16: inte,
// g and d_inte in bf16, the branch and the roundings of the module comment.
template <class T>
__global__ void plain_gate_bwd_kernel(const T* __restrict__ inte,
                                      const float* __restrict__ isc,
                                      const float* __restrict__ ish,
                                      const float* __restrict__ dg,
                                      long long rows, int hk, int four_fin,
                                      int ldg, T* __restrict__ g,
                                      T* __restrict__ d_inte,
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
    const float in = to_f32(inte[o]);
    if constexpr (sizeof(T) == 2) {
      const float gpre = gate_pre_rn(in, a, b);
      const float dgpre = leaky_grad_ge(gpre, dg[og]);
      store_as(g + og, leaky(gpre));
      store_as(d_inte + o, __fmul_rn(dgpre, a));
      s_isc += __fmul_rn(dgpre, in);
      s_ish += dgpre;
    } else {
      const float gpre = gate_pre(in, a, b);
      const float dgpre = leaky_grad(gpre, dg[og]);
      g[og] = leaky(gpre);
      d_inte[o] = dgpre * a;
      s_isc += dgpre * in;
      s_ish += dgpre;
    }
  }
  float* out = scratch + (size_t)blockIdx.y * 2 * four_fin;
  out[ch] = s_isc;
  out[four_fin + ch] = s_ish;
}

// ---------------------------------------------------------------------------
// The bf16 gated stage on Hopper: tail_bwd_bf16_kernel, one launch for dg
// and the gate walk; dg lives in wgmma accumulators and is never written.
// A persistent block takes items of 64 rows times kTbCB = 16 channels c0..
// (channel blocks fastest), fed by one TMA warp through a ring of stages,
// and two consumer warpgroups: warpgroup wg takes channels c0 + 8 wg ..
// The wi box of a stage holds the 16 channels of KS slots, slot-major (row
// s * 16 + c); warpgroup wg reads its 8-row groups 2s + wg (a descriptor
// stride of 2048 bytes), so wgmma's accumulator layout gives its thread
// 32w + 4g + t every slot of channels c0 + 8 wg + 2t (+1) of rows 16w + g
// (+8): the softmax's max, sum and dot over the slots are thread-local.
// In ring order, an item:
//   the slot logits, up to LG slots a position: h's 64 x 64 box of each
//   slot against the 8 rows of w2k^T's 16 x 64 box that are the
//   warpgroup's channels (wgmma m64n8k16, fp32 accumulation of exact bf16
//   products), plus w2b, kept as conv_all2's output v in shared memory,
//   each thread's values at its own words;
//   dg = dy wi^T over 2F in stages of 64: dy's 64 x 64 box against wi's
//   3-D box (64 of 2F, the 16 channels, KS slots) of wi viewed (k, 2Fin,
//   2F), which is K-major as it lies (wgmma m64n(8 KS)k16, fp32);
//   inte's 3-D box (16 channels, KS slots, 64 rows) when 2Fin is a
//   multiple of 8 (else plain loads);
// then the walks of the module comment at its rounding points, slot by slot
// in registers: walk A writes g (the d_wi operand) and d_inte and keeps du
// = dg LeakyReLU(inte isc + ish) in dg's registers, walk B writes dv. The
// seven channel sums go over the warp's rows by a fixed butterfly, then
// over the warpgroup's four warps in order, to one scratch row per row
// tile, which column_reduce adds in order. KS = 10 (k <= 10: N = 80 a
// warpgroup) or 16 (k <= 16: N = 128); one block an SM (ptxas: 152
// registers at KS = 10, no spills; two blocks an SM capped it at 96 and
// spilled: 6.50 against 4.89 ms at stage 4, B=35). Wider k (the entry
// hands k > kTbFastK to pdgn_bilateral_tail_bwd_bf16) would need the
// slots in chunks with the logits made three times and dg twice: that
// route took 22.3 ms at stage 4, B=35, k = 18 against the chain's 13.7.
constexpr int kTbCB = 16;                   // channels an item
constexpr int kTbFastK = 16;                // the widest k: N = 16 k <= 256
constexpr int kTbRows = 64;                 // rows an item
constexpr int kTbThreads = 288;             // 2 consumer warpgroups, TMA warp
constexpr int kTbBoxA = kTbRows * 64 * 2;   // dy or h: 64 rows x 64
constexpr int kTbBoxW2k = kTbCB * 64 * 2;   // w2k^T's channels x 64
template <int KS>
constexpr int kTbStages = KS <= 10 ? 2 : 3;
template <int KS>
constexpr int kTbStage = kTbBoxA + KS * kTbCB * 128;  // A, then wi's box
template <int KS>
constexpr int kTbSmem = 1024 + kTbStages<KS> * kTbStage<KS> +
                        KS * 8 * 128 * 4 +          // v
                        4 * kSums * kTbCB * 4 +     // the warps' sums
                        2 * kTbStages<KS> * 8;      // barriers

struct TailBwdArgs {
  const __nv_bfloat16* inte;  // (rows, K); read directly when !inte_tma
  const float* isc;
  const float* ish;
  const float* w2b;
  const float* s2;
  const float* t2;
  __nv_bfloat16* g;           // (rows, ldg)
  __nv_bfloat16* d_inte;      // (rows, K)
  __nv_bfloat16* dv;          // (rows * k, ldv), zeros in [2Fin, ldv)
  float* scratch;             // (row tiles, 7, 2Fin)
  int rows, k, two_fin, ldg, ldv, dstages, softmax, inte_tma;
};

// a pair of bf16 values at p, p + 1 (a 4-byte store where both are in and
// p is even), else each one that is in
__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* p, float v0,
                                                float v1, bool in0, bool in1,
                                                bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (in0) p[0] = __float2bfloat16_rn(v0);
    if (in1) p[1] = __float2bfloat16_rn(v1);
  }
}

template <int KS>
__global__ void __launch_bounds__(kTbThreads, 1)
tail_bwd_bf16_kernel(const __grid_constant__ CUtensorMap map_dy,
                     const __grid_constant__ CUtensorMap map_wi,
                     const __grid_constant__ CUtensorMap map_h,
                     const __grid_constant__ CUtensorMap map_w2k,
                     const __grid_constant__ CUtensorMap map_inte,
                     const TailBwdArgs a) {
  constexpr int N = KS * kTbCB;
  constexpr int SB = kTbStage<KS>;
  constexpr int LG = (SB - kTbBoxW2k) / kTbBoxA;  // slots a logits position
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* vsm = reinterpret_cast<float*>(ring_s + kTbStages<KS> * SB);
  float* red = vsm + KS * 8 * 128;  // the warps' sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 4 * kSums * kTbCB);
  const Ring ring{bars, bars + kTbStages<KS>, kTbStages<KS>};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // persistent: block b takes items b, b + gridDim.x, ..; item = (row
  // tile rt, channel block), channel blocks fastest (a row tile's dy and h
  // stay in L2 while its blocks run)
  const int ncb = (a.two_fin + kTbCB - 1) / kTbCB;
  const int items = ncb * ((a.rows + kTbRows - 1) / kTbRows);
  int c0 = 0, r0 = 0, rt = 0;
  auto set_item = [&](int item) {
    rt = item / ncb;
    c0 = (item - rt * ncb) * kTbCB;
    r0 = rt * kTbRows;
  };
  const int k = a.k;
  if (threadIdx.x == 0) {
    ring.init(1, 8);  // the TMA thread; the eight consumer warps
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane != 0) return;
    int it = 0;
    auto take = [&](uint32_t bytes) {
      ring.wait_empty(it);
      mbar_arrive_tx(ring.full_bar(it), bytes);
      return ring_s + ring.stage(it) * SB;
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      set_item(item);
      for (int s = 0; s < k; s += LG, ++it) {  // the logits' positions
        const int n = min(LG, k - s);
        uint8_t* st = take(n * kTbBoxA + kTbBoxW2k);
        for (int j = 0; j < n; ++j)
          tma_load_3d(st + j * kTbBoxA, &map_h, ring.full_bar(it), 0, s + j,
                      r0);
        tma_load_3d(st + LG * kTbBoxA, &map_w2k, ring.full_bar(it), 0, 0,
                    c0);
      }
      for (int d = 0; d < a.dstages; ++d, ++it) {  // dg's stages
        uint8_t* st = take(kTbBoxA + N * 128);
        tma_load_3d(st, &map_dy, ring.full_bar(it), 64 * d, 0, r0);
        tma_load_3d(st + kTbBoxA, &map_wi, ring.full_bar(it), 64 * d, c0, 0);
      }
      if (a.inte_tma) {
        uint8_t* st = take(kTbRows * KS * kTbCB * 2);
        tma_load_3d(st, &map_inte, ring.full_bar(it), c0, 0, r0);
        ++it;
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes channels c0 + 8 wg .. of the item,
  // its B rows the 8-row groups 2s + wg of each stage's wi box (a
  // descriptor stride of 2048 bytes) and group wg of w2k's box; its thread
  // tw = 32 wq + 4g + t holds rows 16 wq + g + 8 half of channels c0 + 8
  // wg + 2t + e, position p = 2 half + e of each slot's accumulators
  constexpr int NW = KS * 8;  // a warpgroup's dg columns
  const int wg = warp >> 2, wq = warp & 3, tw = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int two_fin = a.two_fin;
  const size_t K = (size_t)k * two_fin;
  float acc[NW / 2];
  int it = 0;
  auto ld = [&](const float* p, int c) { return c < two_fin ? p[c] : 0.f; };
  auto chan = [&](int e) { return c0 + 8 * wg + 2 * t + e; };
  float* vw = vsm + wg * KS * 4 * 128;  // the warpgroup's v words
  auto vat = [&](int sl, int p) { return vw[(sl * 4 + p) * 128 + tw]; };
  // one logits position: n <= LG slots, conv_all2's outputs handed to
  // use(local slot, v) in slot order
  auto conv = [&](int n, int sl0, auto&& use) {
    ring.wait_full(it);
    const uint8_t* st = ring_s + ring.stage(it) * SB;
    float v[LG][4];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < LG; ++j)
      if (j < n) {
        const uint64_t da = sw128_desc(st + j * kTbBoxA);
        const uint64_t db = sw128_desc(st + LG * kTbBoxA + 1024 * wg);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<8>(v[j], da + 2 * kk, db + 2 * kk, kk > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < LG; ++j) fence_regs(v[j]);
    if (lane == 0) ring.release(it);
    ++it;
    const float bias[2] = {ld(a.w2b, chan(0)), ld(a.w2b, chan(1))};
#pragma unroll
    for (int j = 0; j < LG; ++j)
      if (j < n) {
#pragma unroll
        for (int p = 0; p < 4; ++p) v[j][p] += bias[p & 1];
        use(sl0 + j, v[j]);
      }
  };
  auto logits = [&](int ns) {
#pragma unroll 1
    for (int sl = 0; sl < ns; sl += LG)
      conv(min(LG, ns - sl), sl, [&](int slot, const float (&v)[4]) {
#pragma unroll
        for (int p = 0; p < 4; ++p) vw[(slot * 4 + p) * 128 + tw] = v[p];
      });
  };
  // the warpgroup's dg of a chunk into acc
  auto dg = [&]() {
    for (int d = 0; d < a.dstages; ++d, ++it) {
      ring.wait_full(it);
      const uint8_t* st = ring_s + ring.stage(it) * SB;
      wgmma_slab<4, NW>(acc, sw128_desc(st),
                        sw128_desc(st + kTbBoxA + 1024 * wg, 2048), d > 0);
      wgmma_wait<1>();
      if (d > 0 && lane == 0) ring.release(it - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) ring.release(it - 1);
  };
  // inte at (local row rl, slot s, channel c0 + cc)
  const __nv_bfloat16* xs = nullptr;
  auto inte_at = [&](int rl, int s, int cc) {
    if (a.inte_tma) return __bfloat162float(xs[(rl * KS + s) * kTbCB + cc]);
    const int row = r0 + rl, c = c0 + cc;
    return row < a.rows && c < two_fin
               ? __bfloat162float(a.inte[(size_t)row * K + (size_t)s * two_fin
                                         + c])
               : 0.f;
  };
  const bool even = (two_fin & 1) == 0;

  // the softmax at the thread's positions (mx, nz the normaliser's
  // reciprocal),
  // dot, and the sums (sa: isc even | odd slots, ish even | odd; sb: s2,
  // t2, w2b); reset an item
  float mx[2][2], nz[2][2], dot[2][2], sa[4][2], sb[3][2];
  auto logit = [&](float v, float sc, float sh) {
    return leaky(slot_pre_rn(v, sc, sh));
  };
  auto weight = [&](float u, float m, float z) {
    return a.softmax ? expf(u - m) * z : u;
  };

  // the walks over the k slots (the module comment's)
  auto walk_a = [&]() {
    float sc[2], sh[2], ia[2][2], ib[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = chan(e);
      sc[e] = ld(a.s2, c);
      sh[e] = ld(a.t2, c);
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        ia[par][e] = ld(a.isc + par * two_fin, c);
        ib[par][e] = ld(a.ish + par * two_fin, c);
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if (s >= k) break;
      const int par = s & 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = 16 * wq + g + 8 * half, cc = 8 * wg + 2 * t;
        float go[2], di[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 2 * half + e;
          const float x = inte_at(rl, s, cc + e);
          const float dgv = acc[4 * s + p];
          const float w = weight(logit(vat(s, p), sc[e], sh[e]),
                                 mx[half][e], nz[half][e]);
          const float a0 = par ? ia[1][e] : ia[0][e];
          const float b0 = par ? ib[1][e] : ib[0][e];
          const float gpre = gate_pre_rn(x, a0, b0);
          const float lg = leaky(gpre);
          const float dgpre = leaky_grad_ge(gpre, __fmul_rn(dgv, w));
          if (par) {
            sa[1][e] += __fmul_rn(dgpre, x);
            sa[3][e] += dgpre;
          } else {
            sa[0][e] += __fmul_rn(dgpre, x);
            sa[2][e] += dgpre;
          }
          const float du = __fmul_rn(dgv, lg);
          dot[half][e] += __fmul_rn(du, w);
          acc[4 * s + p] = du;
          go[e] = __fmul_rn(lg, w);
          di[e] = __fmul_rn(dgpre, a0);
        }
        const int row = r0 + rl, c = c0 + cc;
        if (row < a.rows) {
          const bool in0 = c < two_fin, in1 = c + 1 < two_fin;
          const bool pair = in1 && even;
          store_bf16_pair(a.g + (size_t)row * a.ldg + (size_t)s * two_fin +
                              c, go[0], go[1], in0, in1, pair);
          store_bf16_pair(a.d_inte + (size_t)row * K + (size_t)s * two_fin +
                              c, di[0], di[1], in0, in1, pair);
        }
      }
    }
  };
  // walk B: acc holds walk A's du
  auto walk_b = [&]() {
    float sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[e] = ld(a.s2, chan(e));
      sh[e] = ld(a.t2, chan(e));
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if (s >= k) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = 16 * wq + g + 8 * half, cc = 8 * wg + 2 * t;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 2 * half + e;
          const float v = vat(s, p);
          const float upre = slot_pre_rn(v, sc[e], sh[e]);
          const float w = weight(leaky(upre), mx[half][e], nz[half][e]);
          const float du = acc[4 * s + p];
          const float da = a.softmax ? __fmul_rn(w, du - dot[half][e]) : du;
          const float dpre = leaky_grad_ge(upre, da);
          sb[0][e] += __fmul_rn(dpre, v);
          sb[1][e] += dpre;
          o[e] = __fmul_rn(dpre, sc[e]);
          sb[2][e] += o[e];
        }
        const int row = r0 + rl, c = c0 + cc;
        if (row < a.rows && c < a.ldv)   // c even, ldv a multiple of 8
          store_bf16_pair(a.dv + ((size_t)row * k + s) * a.ldv + c,
                          c < two_fin ? o[0] : 0.f,
                          c + 1 < two_fin ? o[1] : 0.f, true, true, true);
      }
    }
  };
  // the softmax over the k slots in v's words: gate_tc_kernel's order,
  // the maximum, z over ascending slots, one reciprocal
  auto stats = [&]() {
    if (!a.softmax) return;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sc = ld(a.s2, chan(e)), sh = ld(a.t2, chan(e));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 2 * half + e;
        float m = logit(vat(0, p), sc, sh);
        for (int sl = 1; sl < k; ++sl) m = fmaxf(m, logit(vat(sl, p), sc, sh));
        float z = 0.f;
        for (int sl = 0; sl < k; ++sl) z += expf(logit(vat(sl, p), sc, sh) - m);
        mx[half][e] = m;
        nz[half][e] = 1.f / z;
      }
    }
  };
  // the sums over each warp's rows (a fixed butterfly over g) into the
  // warp's row of red
  auto reduce = [&]() {
#pragma unroll
    for (int m = 0; m < kSums; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = m < 4 ? sa[m][e] : sb[m - 4][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[(wq * kSums + m) * kTbCB + 8 * wg + 2 * t + e] = v;
      }
  };
  // the item's inte box: wait for it (TMA), and its release
  auto inte_take = [&]() {
    if (!a.inte_tma) return;
    ring.wait_full(it);
    xs = reinterpret_cast<const __nv_bfloat16*>(ring_s + ring.stage(it) * SB);
  };
  auto inte_give = [&]() {
    if (!a.inte_tma) return;
    __syncwarp();  // the warp's reads are done
    if (lane == 0) ring.release(it);
    ++it;
  };

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    set_item(item);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h][e] = -INFINITY;
        nz[h][e] = 0.f;
        dot[h][e] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) sa[m][e] = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) sb[m][e] = 0.f;
    }
    logits(k);
    dg();
    inte_take();
    stats();
    walk_a();
    walk_b();
    inte_give();
    reduce();

    // the block's sums over the four warps of each warpgroup in order,
    // one scratch row per row tile
    bar_sync(1, 256);
    for (int e = threadIdx.x; e < kSums * kTbCB; e += 256) {
      const int m = e / kTbCB, cc = e - m * kTbCB;
      if (c0 + cc >= two_fin) continue;
      float v = red[m * kTbCB + cc];
#pragma unroll
      for (int w = 1; w < 4; ++w) v += red[(w * kSums + m) * kTbCB + cc];
      a.scratch[((size_t)rt * kSums + m) * two_fin + c0 + cc] = v;
    }
    bar_sync(1, 256);  // red is read before the next item writes it
  }
}

template <int KS>
cudaError_t launch_tail_bwd_bf16(const CUtensorMap* maps,
                                 const TailBwdArgs& a, int sms,
                                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tail_bwd_bf16_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTbSmem<KS>);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((a.two_fin + kTbCB - 1) / kTbCB) *
                          ((a.rows + kTbRows - 1) / kTbRows);
  const dim3 grid((unsigned)(items < sms ? items : sms));
  tail_bwd_bf16_kernel<KS><<<grid, kTbThreads, kTbSmem<KS>, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return cudaGetLastError();
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
    err = launch_gate_bwd(k, inte, h, dg, isc, ish, w2k, w2b, s2, t2, kink,
                          rows, two_fin, ldg, ldv, softmax, g, d_inte, dv,
                          sum_scratch, stream);
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
    plain_gate_bwd_kernel<float><<<grid, 128, 0, stream>>>(
        inte, isc, ish, dg, prow, hk, four_fin, ldg, g, d_inte, sum_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(sum_scratch, nblk, 2 * four_fin, sums, stream);
    PDGN_CHECK_LAUNCH();
  }

  // 3. d_wi = g^T dy
  return (int)tc_gemm_tn(RowsA{g, ldg}, dy, t4, rows, ldg, two_f, tn_scratch,
                         d_wi, stream);
}

// The bf16 instance on the core: the plain stage, and the gated stage at
// k > kTbFastK (pdgn_bilateral_tail_gated_bwd_bf16 takes smaller k). As
// pdgn_bilateral_tail_bwd, with inte, h, w2k (64, 2Fin), w2k_t (ldv, 64),
// wi_t (t8, ldg) and dy (rows, t8) in bf16 (dy the tail's bf16
// cotangent, zero-padded), ldg, t8 and ldv multiples of 8 (a bf16
// granule); no kink. Outputs d_inte, d_h in bf16, the rest fp32 as there.
// Scratch: g (rows, ldg) and dv (rows*k, ldv) in bf16, dg (rows, ldg)
// fp32, tn_scratch, sum_scratch and colsum as there.
int pdgn_bilateral_tail_bwd_bf16(
    const __nv_bfloat16* inte, const __nv_bfloat16* h, const float* isc,
    const float* ish, const __nv_bfloat16* w2k, const __nv_bfloat16* w2k_t,
    const float* w2b, const float* s2, const float* t2,
    const __nv_bfloat16* wi_t, const __nv_bfloat16* dy, int rows, int k,
    int two_fin, int two_f, int ldg, int t8, int ldv, int softmax,
    __nv_bfloat16* d_inte, __nv_bfloat16* d_h, float* d_w2k, float* d_wi,
    float* d_bias, float* sums, __nv_bfloat16* g, float* dg,
    __nv_bfloat16* dv, float* tn_scratch, float* sum_scratch, float* colsum,
    cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int hk = k / 2;
  const int four_fin = 2 * two_fin;
  const int K = k * two_fin;
  if (k < 2 || k % 2 || ldg < K || ldg % 8 || t8 < two_f || t8 % 8 ||
      (h != nullptr && (ldv < two_fin || ldv % 8 || k > kGateMaxK)))
    return (int)cudaErrorInvalidValue;

  // 1. dg = dy wi^T (fp32), and d_bias from dy's fp32 upcast
  cudaError_t err = tc_gemm<false, kGFold>(RowsBf16{dy, t8}, wi_t, ldg, rows,
                                           K, t8, t8, StorePairs{dg, ldg},
                                           stream);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (rows + 255) / 256;
  chunk_colsum(PlainBf16{dy, t8}, (long long)rows, two_f, 256, colsum,
               stream);
  column_reduce(colsum, nchunk, two_f, d_bias, stream);
  PDGN_CHECK_LAUNCH();

  // 2. the gate pass: g, d_inte, dv and the sums
  if (h != nullptr) {
    err = launch_gate_bwd(k, inte, h, dg, isc, ish, w2k, w2b, s2, t2,
                          (const float*)nullptr, rows, two_fin, ldg, ldv,
                          softmax, g, d_inte, dv, sum_scratch, stream);
    if (err != cudaSuccess) return (int)err;
    column_reduce(sum_scratch, gate_bwd_blocks(rows), kSums * two_fin, sums,
                  stream);
    PDGN_CHECK_LAUNCH();
    // conv_all2's backward on bf16 dv
    const int hrows = rows * k;
    err = tc_gemm<false, kGFold>(RowsBf16{dv, ldv}, w2k_t, kHidden, hrows,
                                 kHidden, ldv, ldv,
                                 AddStoreTo<bf16>{d_h, nullptr, nullptr,
                                                  kHidden, kHidden},
                                 stream);
    if (err != cudaSuccess) return (int)err;
    err = tc_gemm_tn(RowsBf16{h, kHidden}, dv, ldv, hrows, kHidden, two_fin,
                     tn_scratch, d_w2k, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    const long long prow = (long long)rows * hk;
    const int nblk = (int)((prow + kPlainRows - 1) / kPlainRows);
    dim3 grid((four_fin + 127) / 128, nblk);
    plain_gate_bwd_kernel<bf16><<<grid, 128, 0, stream>>>(
        inte, isc, ish, dg, prow, hk, four_fin, ldg, g, d_inte, sum_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(sum_scratch, nblk, 2 * four_fin, sums, stream);
    PDGN_CHECK_LAUNCH();
  }

  // 3. d_wi = g^T dy
  return (int)tc_gemm_tn(RowsBf16{g, ldg}, dy, t8, rows, ldg, two_f,
                         tn_scratch, d_wi, stream);
}

// The gated bf16 stage (module comment; tail_bwd_bf16_kernel). bf16 inte
// (rows, K) and h (rows, k*64), 16-byte aligned; w2k_t (ldv, 64) = w2k^T
// with zero rows past 2Fin (the logits' B), w2k_p (64, ldv) = w2k with
// zero columns past 2Fin (d_h's B); wi (K, t8) and dy (rows, t8)
// zero-padded; ldg, t8 and ldv multiples of 8; k <= kTbFastK (wider k
// takes pdgn_bilateral_tail_bwd_bf16). Outputs: d_inte like inte and d_h
// like h in bf16; d_w2k (64, ldv) (the columns past 2Fin zero), d_wi (K,
// 2F), d_bias (2F) and sums (7, 2Fin, as pdgn_bilateral_tail_bwd's) in
// fp32. Scratch: g (rows, ldg) and dv (rows * k, ldv) in bf16; part (the
// larger of split_wi * K * 2F and split_w2k * 64 * ldv floats);
// sum_scratch (ceil(rows / 64), 7 * 2Fin); colsum (ceil(rows / 256), 2F).
int pdgn_bilateral_tail_gated_bwd_bf16(
    const __nv_bfloat16* inte, const __nv_bfloat16* h, const float* isc,
    const float* ish, const __nv_bfloat16* w2k_t, const float* w2b,
    const float* s2, const float* t2, const __nv_bfloat16* wi,
    const __nv_bfloat16* w2k_p, const __nv_bfloat16* dy, int rows, int k,
    int two_fin, int two_f, int ldg, int t8, int ldv, int softmax,
    int split_wi, int split_w2k, int sms,
    __nv_bfloat16* d_inte, __nv_bfloat16* d_h, float* d_w2k,
    float* d_wi, float* d_bias, float* sums, __nv_bfloat16* g,
    __nv_bfloat16* dv, float* part, float* sum_scratch, float* colsum,
    cudaStream_t stream) {
  const int K = k * two_fin;
  const long long hrows = (long long)rows * k;
  if (k < 2 || k % 2 || k > kTbFastK || ldg < K || ldg % 8 ||
      t8 < two_f || t8 % 8 || ldv < two_fin || ldv % 8 || two_f % 2 ||
      rows < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;

  // 1. d_bias from dy's fp32 upcast
  chunk_colsum(PlainBf16{dy, t8}, (long long)rows, two_f, 256, colsum,
               stream);
  column_reduce(colsum, (rows + 255) / 256, two_f, d_bias, stream);
  PDGN_CHECK_LAUNCH();

  // 2. dg and the gate walk in one launch: g, d_inte, dv and the sums
  const bool ks16 = k > 10;
  CUtensorMap maps[5];
  cudaError_t err = bf16_tile_map_3d(&maps[0], dy, t8, 1, rows, t8, t8, 64,
                                     1, kTbRows);
  if (err == cudaSuccess)
    err = bf16_tile_map_3d(&maps[1], wi, t8, two_fin, k, t8,
                           (long long)two_fin * t8, 64, kTbCB,
                           ks16 ? 16 : 10);
  if (err == cudaSuccess)
    err = bf16_tile_map_3d(&maps[2], h, kHidden, k, rows, kHidden,
                           (long long)k * kHidden, 64, 1, kTbRows);
  if (err == cudaSuccess)
    err = bf16_tile_map_3d(&maps[3], w2k_t, kHidden, 1, ldv, kHidden,
                           kHidden, 64, 1, kTbCB);
  const int inte_tma = two_fin % 8 == 0;
  maps[4] = maps[0];  // unused unless inte goes by TMA
  if (err == cudaSuccess && inte_tma)
    err = bf16_tile_map_3d(&maps[4], inte, two_fin, k, rows, two_fin, K,
                           kTbCB, ks16 ? 16 : 10, kTbRows,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  const TailBwdArgs ta{inte, isc, ish, w2b, s2, t2, g, d_inte, dv,
                       sum_scratch, rows, k, two_fin, ldg, ldv,
                       (t8 + 63) / 64, softmax, inte_tma};
  err = ks16 ? launch_tail_bwd_bf16<16>(maps, ta, sms, stream)
             : launch_tail_bwd_bf16<10>(maps, ta, sms, stream);
  if (err != cudaSuccess) return (int)err;
  column_reduce(sum_scratch, (rows + kTbRows - 1) / kTbRows, kSums * two_fin,
                sums, stream);
  PDGN_CHECK_LAUNCH();

  // 3. conv_all2's backward on product_bf16_kernel: d_h = dv w2k^T
  // (K-major, w2k_p (64, ldv): 64 of a tile's 256 columns, rounded to bf16
  // at the store; it took 0.281 ms at stage 4, B=35 against the core's
  // 0.328), d_w2k = h^T dv (MN-major, split over the hrows rows, the
  // partials added in order)
  CUtensorMap map_a, map_b;
  err = bf16_tile_map_3d(&map_a, dv, ldv, 1, hrows, ldv, ldv, 64, 1, kPM);
  if (err == cudaSuccess)
    err = bf16_tile_map_3d(&map_b, w2k_p, ldv, 1, kHidden, ldv, ldv, 64, 1,
                           kPN);
  if (err != cudaSuccess) return (int)err;
  const ProductArgs ph{(int)hrows, 1, (int)((hrows + kPM - 1) / kPM),
                       kHidden, 1, (ldv + kPK - 1) / kPK, 0, 0, nullptr,
                       kHidden, d_h};
  err = launch_product_bf16<false>(map_a, map_b, ph, 1, stream);
  if (err != cudaSuccess) return (int)err;
  err = bf16_tile_map_3d(&map_a, h, kHidden, 1, hrows, kHidden, kHidden, 64,
                         1, kPK);
  if (err == cudaSuccess)
    err = bf16_tile_map_3d(&map_b, dv, ldv, 1, hrows, ldv, ldv, 64, 1, kPK);
  if (err != cudaSuccess) return (int)err;
  const ProductArgs pw{kHidden, 1, 1, ldv, 1, (int)((hrows + kPK - 1) / kPK),
                       0, 0, part, ldv};
  err = launch_product_bf16<true>(map_a, map_b, pw, split_w2k, stream);
  if (err != cudaSuccess) return (int)err;
  column_reduce(part, split_w2k, kHidden * ldv, d_w2k, stream);
  PDGN_CHECK_LAUNCH();

  // 4. d_wi = g^T dy (the TPU kernel's g_b^T dout_b), likewise
  err = bf16_tile_map_3d(&map_a, g, ldg, 1, rows, ldg, ldg, 64, 1, kPK);
  if (err == cudaSuccess)
    err = bf16_tile_map_3d(&map_b, dy, t8, 1, rows, t8, t8, 64, 1, kPK);
  if (err != cudaSuccess) return (int)err;
  const ProductArgs pi{K, 1, (K + kPM - 1) / kPM, two_f, 1,
                       (rows + kPK - 1) / kPK, 0, 0, part, two_f};
  err = launch_product_bf16<true>(map_a, map_b, pi, split_wi, stream);
  if (err != cudaSuccess) return (int)err;
  column_reduce(part, split_wi, K * two_f, d_wi, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
