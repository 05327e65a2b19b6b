// Edge-conv stage tail for Hopper (sm_90a).
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/bilateral_tail.py::_gated_kernel
// (stages 2-4) and ::_plain_kernel (stage 1), launcher _pallas_tail:
//   gated: y = partial + (LeakyReLU(inte*isc + ish)
//                         * softmax_slots(LeakyReLU((h@w2k + w2b)*s2 + t2))) @ wi
//              + bias
//   plain: y = partial + LeakyReLU(inte*isc + ish) @ wi + bias
//
// The fp32 instance (pdgn_bilateral_tail) and the plain bf16 stage
// (pdgn_bilateral_tail_plain_bf16). What bounds it on the H100:
// operations. At stage 4, B=128 the merge is 687 GFLOP and conv_all2 86
// GFLOP, both products that run on the tensor cores in 3xTF32 (495 / 3
// TFLOP/s of fp32-accurate work), against ~6 GB of reads and writes.
// The design, two launches:
//   1. the gate g (rows, ldg) on the tensor cores (tail_gate.cuh's
//      gate_tc_kernel, which the backward recomputes g with), or the plain
//      stage's elementwise gate;
//   2. the merge y = (partial + g @ wi) + bias on the shared product core
//      (tf32x3_gemm.cuh), folded: depth k/2 * 4Fin (5,120 at stage 4).
// The plain bf16 stage takes the plain gate's bf16 instance (g rounded to
// bf16 where the TPU kernel rounds it) and the core's bf16 instance
// (m16n8k16, fp32 accumulation), partial and the bias added in fp32, y
// rounded once.
//
// The bf16 gated instance (pdgn_bilateral_tail_gated_bf16; the TPU kernel
// with bf16 inte, h and weights, bilateral_tail.py:74-114) is one launch
// that never writes g, as the TPU kernel keeps each step's gate in VMEM.
// The two-launch design it replaces wrote g (1.34 GB at stage 4, B=128) to
// device memory and read it back, and ran the merge on mma.sync at a
// quarter of the card's bf16 rate. What bounds it: operations, 85.9 GFLOP
// of slot logits and 687.2 GFLOP of merge at stage 4, B=128 (0.864 ms with
// the gate's SIMT work, as chip_smoke.py counts it). In practice the
// gate bounds it: its logits' TF32 products and their fold, an expf and
// gate_value's three bf16 roundings a gate value, on the producer warps;
// then the 10.7 GB of packed wi slabs its consumers stream from L2.
//
// tail_bf16_kernel: persistent, 384 threads a block (one consumer
// warpgroup, two producer warpgroups), in clusters of two blocks. A
// cluster's work item is a 64-row tile and 512 columns of 2F, in
// round-robin (every item carries the same work); block rank r multiplies
// columns r * 256 .. + 255, and makes rows r * 32 .. + 31 of every A slab.
// The merge depth runs in slabs of 32 channels of one slot, chunk outer,
// slot inner (depth index (chunk * k + slot) * 32 + j, the order in which
// pack_tail_wi_bf16 lays wi^T out K-major, zero rows past 2Fin), so that
// the k slabs of a channel chunk come out of one softmax:
//   - the producers, a warp an 8-channel column of one 16-row group, keep
//     the block's h rows of the item as the logits' bf16 A fragments (laid
//     out once an item), take the k slot logits with GateThreadT::
//     logits_frag (the mma.sync TF32 fragments and ks order of
//     gate_tc_kernel and of the backward's gate pass: the same bits), the
//     softmax in gate_tc_kernel's order (k <= 16: maximum, sum in
//     ascending slot order, one reciprocal; wider k: the two-pass online
//     softmax, expf(u - m) / z) and gate_value's three bf16 roundings, with
//     each chunk's inte channels staged by cp.async a chunk ahead; they
//     store every gate value pair straight into the chunk's k A slabs (64
//     rows x 32 channels, the 64-byte swizzle), fence them into the async
//     proxy, and the leader copies the block's 32 rows of each slab into
//     the other block's by one bulk copy, completing on its full barrier;
//   - the A ring holds two chunks (groups) of slabs with a full and an
//     empty barrier each; both blocks fill every group in the consumers'
//     order, and a group is freed once the consumers of both blocks are
//     done with it, so neither producer runs ahead of the other;
//   - the consumer warpgroup waits on a group, then for each slab on its
//     packed wi (64 deep x 256 columns a stage: two slabs, one TMA box in
//     the 128-byte swizzle, two stages) and runs two wgmma m64n256k16 a
//     slab (bf16 operands, fp32 accumulation); the last of its four warps
//     to finish with a wi stage refills it, so no warp waits for another;
//   - the epilogue: y = (partial + acc) + bias in fp32, rounded to bf16 at
//     the store, as AddStoreTo does.
// Tried on the H100 and not kept: one block of 128 x 256 items (the gate
// made twice), one block of 64 x 512 items with one producer warpgroup
// (producer-bound), setmaxnreg with two producer warpgroups (ptxas keeps
// the launch bound's 128 registers for the consumers), the gate's h as
// fp32 fragments, two 16-row tiles a producer warp (spills), chunks
// alternating between the two blocks (a ring slot each), a dedicated TMA
// warp (416 threads cap every thread at 128 registers), one-slab wi stages.
// With g_probe non-null the producer also copies the gate values it made
// into g_probe (rows, k * 2Fin), for checks; the main path passes null.
#include "hopper.cuh"
#include "tail_gate.cuh"
#include "tf32x3_gemm.cuh"

namespace {

template <class T, class ALoad>
int bilateral_tail(const float* partial, const T* inte, const T* h,
                   const float* isc, const float* ish, const T* w2k,
                   const float* w2b, const float* s2, const float* t2,
                   const T* wi, int ldw, const float* bias, int rows, int k,
                   int four_fin, int two_f, int ldg, int softmax, T* g, T* y,
                   cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const int K = (k / 2) * four_fin;
  if (k < 2 || k % 2 || ldg < K || ldg % V || ldw < two_f || ldw % V)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_gate(inte, h, isc, ish, w2k, w2b, s2, t2,
                                      rows, k, four_fin, ldg, softmax, g,
                                      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)tc_gemm<false, kGFold>(ALoad{g, ldg}, wi, ldw, rows, two_f, ldg,
                                     ldg, AddStoreTo<T>{y, partial, bias,
                                                        two_f, two_f},
                                     stream);
}

// ------------------------------------ the bf16 gated instance: one launch
constexpr int kTM = 64;           // rows a cluster's tile: one m64 tile
constexpr int kTRows = 32;        // of them a block's producers make
constexpr int kTN = 256;          // columns a block: one m64n256k16
constexpr int kTNI = 2 * kTN;     // columns a cluster's item
constexpr int kTC = 32;           // channels a slab (64-byte rows)
constexpr int kTConsumers = 128;  // one warpgroup
constexpr int kTProducers = 256;  // two warpgroups
constexpr int kTThreads = kTConsumers + kTProducers;
static_assert(kTC * (kTRows / kGateP) == 8 * (kTProducers / 32),
              "a producer warp an n8 column of one 16-row group");
constexpr int kTABytes = kTM * kTC * 2;        // 4 KB an A slab
constexpr int kTRowsBytes = kTRows * kTC * 2;  // 2 KB: a block's part
constexpr int kTBK = 2 * kTC;                  // depth a wi stage: 2 slabs
constexpr int kTBBytes = kTN * kTBK * 2;       // 32 KB a wi stage
constexpr int kTPass = 8;                      // slabs a group, k > 16
constexpr int kTSmemMax = 232448;              // the H100's dynamic limit
constexpr int kTBarBytes = 256;                // the barriers, the counts

// whether the KR instances stage inte a chunk ahead: where its two buffers
// fit beside the wi stages for every k <= KR (KR = 10; beside KR = 16's
// fragments and A ring they would leave k = 12 one wi stage and k = 14, 16
// none)
template <int KR>
constexpr bool kTailStaged = KR == 10;

struct TailBf16Args {
  const float* partial;        // (rows, two_f)
  const __nv_bfloat16* inte;   // (rows, k * two_fin), slot-major
  const __nv_bfloat16* h;      // (rows, k * 64)
  const float* isc;            // (2 * two_fin)
  const float* ish;
  const __nv_bfloat16* w2k;    // (64, two_fin)
  const float* w2b;            // (two_fin)
  const float* s2;
  const float* t2;
  const float* bias;           // (two_f)
  __nv_bfloat16* y;            // (rows, two_f)
  __nv_bfloat16* g_probe;      // (rows, k * two_fin) or null
  int rows, k, two_fin, two_f, softmax;
  int chunks;                  // channel chunks: ceil(two_fin / kTC)
  int ct;                      // column tiles: ceil(two_f / kTNI)
  int items;                   // row tiles * ct
  int gs;                      // slabs an A group: k, or kTPass above 16
  int b_stages;                // wi stages
  int hl, il;                  // row strides of the staged h and inte
};

// the h rows of slots [s0, s0 + ns) of points [p0, p0 + kTRows), into sh
// (row stride hl), by the producers; rows past the end zero-filled
__device__ __forceinline__ void stage_h(__nv_bfloat16* sh, int hl,
                                        const __nv_bfloat16* __restrict__ h,
                                        int rows, int k, int p0, int s0,
                                        int ns, int pt) {
  const int gran = ns * (kHidden / 8);  // 16-byte granules a row
  for (int e = pt; e < kTRows * gran; e += kTProducers) {
    const int r = e / gran, q = e - r * gran;
    const bool ok = p0 + r < rows;
    cp_async16(sh + r * hl + 8 * q,
               ok ? h + ((size_t)(p0 + r) * k + s0) * kHidden + 8 * q : h,
               ok ? 16 : 0);
  }
}

// inte of the k slots of points [p0, p0 + kTRows), channels [c0, c0 +
// kTC), into si (row stride il: k * kTC + 8, the pad spreading the rows
// over the banks), by the producers (stage_channels: 16-byte copies, or
// plain loads where 2Fin is no multiple of 8; channels past 2Fin and rows
// past the end zero-filled)
__device__ __forceinline__ void stage_inte(__nv_bfloat16* si, int il,
                                           const TailBf16Args& a, int p0,
                                           int c0, int pt) {
  constexpr int G = kTC / 8;  // granules a slot
  const int gran = a.k * G;
  for (int e = pt; e < kTRows * gran; e += kTProducers) {
    const int r = e / gran, q = e - r * gran;
    const int cc = c0 + 8 * (q % G);
    const bool ok = p0 + r < a.rows;
    stage_channels(si + r * il + 8 * q,
                   a.inte + (size_t)(p0 + r) * a.k * a.two_fin +
                       (size_t)(q / G) * a.two_fin + cc,
                   a.inte, ok, cc, a.two_fin);
  }
}

// a block's h rows of a tile (points [p0, p0 + kTRows), all k slots) as
// the slot logits' bf16 A fragments, fragment-major: frag[((hr * k + s) *
// 8 + ks) * 32 + lane] holds lane 4 g + t's A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4] of k8 step ks of slot s of 16-row group hr (GateThreadT::
// logits_frag); rows past the end zeros
__device__ __forceinline__ void make_frag(uint2* frag,
                                          const TailBf16Args& a, int p0,
                                          int pt) {
  for (int e = pt; e < (kTRows / kGateP) * a.k * 8 * 8; e += kTProducers) {
    const int gq = e & 7, ks = (e >> 3) & 7, sr = e >> 6;  // sr = hr k + s
    const int s = sr % a.k, r = p0 + sr / a.k * kGateP + gq;
    const size_t o = ((size_t)r * a.k + s) * kHidden + ks * 8;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (r < a.rows) lo = *reinterpret_cast<const uint4*>(a.h + o);
    if (r + 8 < a.rows)
      hi = *reinterpret_cast<const uint4*>(a.h + o + 8 * a.k * kHidden);
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
    auto half = [](const uint32_t(&w)[4], int j) {  // bf16 j of 8
      return (w[j >> 1] >> (16 * (j & 1))) & 0xffffu;
    };
    uint2* d = frag + (sr * 8 + ks) * 32 + 4 * gq;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      d[t] = make_uint2(half(wl, t) | (half(wh, t) << 16),
                        half(wl, t + 4) | (half(wh, t + 4) << 16));
  }
}

// inte of slot s at the thread's channel pair (c, c + 1) of row p (0 past
// the end or past 2Fin): one 4-byte load when 2Fin is even
__device__ __forceinline__ __nv_bfloat162 load_inte(const TailBf16Args& a,
                                                    int p, int s, int c) {
  __nv_bfloat162 v = __float2bfloat162_rn(0.f);
  if (p >= a.rows || c >= a.two_fin) return v;
  const __nv_bfloat16* x =
      a.inte + (size_t)p * a.k * a.two_fin + (size_t)s * a.two_fin + c;
  if ((a.two_fin & 1) == 0) return *reinterpret_cast<const __nv_bfloat162*>(x);
  v.x = x[0];
  if (c + 1 < a.two_fin) v.y = x[1];
  return v;
}

// The producer's gate of slot s at the thread's four positions (rows g,
// g + 8 of the 16-row group at tile row rl; channels c, c + 1 of its warp's
// column cw), from inte there (x) and the slot weights w: gate_value's
// roundings, stored as a bf16 pair at byte off of this block's A ring
// (64-byte rows, granule cw, swizzled).
__device__ __forceinline__ void put_gate(const TailBf16Args& a,
                                         const GateThreadT<__nv_bfloat16>& th,
                                         uint8_t* as, int off, int rl,
                                         int p0, int s, int cw, int g, int t,
                                         const __nv_bfloat162 x[2],
                                         const float w[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rl + g + 8 * half;
    const int p = p0 + g + 8 * half;
    float v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float xv = q ? __high2float(x[half]) : __low2float(x[half]);
      v[q] = th.live[q] && p < a.rows
                 ? gate_value<__nv_bfloat16>(
                       leaky(gate_pre(xv, th.isc(s, q), th.ish(s, q))),
                       w[2 * half + q])
                 : 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(
        as + off + r * (kTC * 2) + ((cw ^ swizzle64_row(r)) << 4) + 4 * t) =
        __floats2bfloat162_rn(v[0], v[1]);
  }
}

// a check: the gate pairs of slots [s0, s0 + n) that this thread stored
// (put_gate's positions; slot s0 + s at byte off + s * kTABytes), copied
// into g_probe (rows, k * two_fin)
__device__ __noinline__ void probe_gate(const TailBf16Args& a,
                                        const uint8_t* as, int off, int rl,
                                        int p0, int s0, int n, int c, int cw,
                                        int g, int t) {
  for (int s = 0; s < n; ++s)
    for (int half = 0; half < 2; ++half) {
      const int r = rl + g + 8 * half;
      const int p = p0 + g + 8 * half;
      if (p >= a.rows) continue;
      const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(
          as + off + s * kTABytes + r * (kTC * 2) +
          ((cw ^ swizzle64_row(r)) << 4) + 4 * t);
      __nv_bfloat16* d = a.g_probe + (size_t)p * a.k * a.two_fin +
                         (size_t)(s0 + s) * a.two_fin + c;
      if (c < a.two_fin) d[0] = pair.x;
      if (c + 1 < a.two_fin) d[1] = pair.y;
    }
}

// the softmax over the k <= KR logits u of the thread's four positions, in
// place, in gate_tc_kernel's order (the maximum, z summed in ascending slot
// order, one reciprocal; the backward's gate pass forms the same m, z, rz)
template <int KR>
__device__ __forceinline__ void softmax_slots(float (&u)[KR][4], int k) {
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

// A cluster of two blocks makes one item, a 64-row tile and 512 columns of
// 2F; block rank r multiplies columns r * 256 .. + 255 and makes rows
// r * 32 .. + 31 of every A slab, in its own ring and, by a bulk copy, in
// the other block's. The A ring holds two groups of gs slabs (a chunk's k
// slots, or kTPass of them above 16), filled and consumed in the same
// order by both blocks: group q of chunk cc of the cluster's i-th item is
// the launch's group gg = (i * chunks + cc) * ceil(k / gs) + q, in slot
// gg % 2. KR > 0: k <= KR logits a thread in registers, one pass, from the
// block's h rows laid out once an item as fragments (make_frag); kExact (k
// == KR): straight-line slot loops (run-time ones took 6.37-6.38 ms
// against 5.27-5.32 at k = 10, stage 4, B=128, on one H100 in one run:
// PERF.md §6). kTailStaged<KR> (KR = 10): each chunk's inte channels
// staged a chunk ahead (two buffers), else loaded at use.
// KR == 0: any even k <= kGateMaxK, the two-pass online softmax (pass 1
// over chunks of kGateChunk staged slots, pass 2 a group at a time).
// Dynamic shared memory: the A ring (2 gs slabs of 4 KB), the wi ring
// (b_stages stages of 32 KB), both 1024-aligned, the barriers and the wi
// stages' counts, then the h fragments of the block's rows (two-pass: 32
// staged rows of hl bf16) and, staged, two inte buffers (32 rows of il
// bf16).
template <int KR, bool kExact>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kTThreads, 1)
tail_bf16_kernel(const __grid_constant__ CUtensorMap map_wi,
                 const TailBf16Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Bs = As + 2 * a.gs * kTABytes;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(Bs + a.b_stages * kTBBytes);
  uint64_t* a_empty = a_full + 2;
  // the wi ring (hopper.cuh's Ring: its full barriers; a stage is freed by
  // the consumer warps' count, b_count, instead of an empty barrier)
  const Ring rb{a_empty + 2, nullptr, a.b_stages};
  int* b_count = reinterpret_cast<int*>(rb.full + 4);
  uint8_t* Hs = reinterpret_cast<uint8_t*>(a_full) + kTBarBytes;
  __nv_bfloat16* Is = reinterpret_cast<__nv_bfloat16*>(
      Hs + (KR > 0 ? a.k * (kTRows / kGateP) * 8 * 32 * 8
                   : kTRows * a.hl * 2));
  const uint32_t rank = cluster_ctarank(), peer_rank = rank ^ 1;
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&a_full[s], 1);  // this block's producers' leader (and the
                                 // other block's rows, as bytes)
      mbar_init(&a_empty[s], 2 * kTConsumers / 32);  // both blocks' warps
    }
    for (int s = 0; s < a.b_stages; ++s) {
      mbar_init(&rb.full[s], 1);  // the issuer, and its bytes
      b_count[s] = 0;
    }
    mbar_init_fence();
  }
  cluster_sync();  // every barrier of the cluster is initialised

  const int nslab = a.chunks * a.k;             // A slabs an item
  const int ngc = (a.k + a.gs - 1) / a.gs;      // A groups a chunk
  auto g_index = [&](int i, int cc, int q) {
    return (i * a.chunks + cc) * ngc + q;
  };
  auto g_slab = [&](int gg, int s) {  // byte offset of a group's slab
    return ((gg & 1) * a.gs + s) * kTABytes;
  };
  auto g_parity = [&](int gg) { return (uint32_t)(gg >> 1) & 1; };
  auto b_cols = [&](int item) {  // this block's columns of an item
    return item % a.ct * kTNI + (int)rank * kTN;
  };

  if (threadIdx.x >= kTConsumers) {
    // ------------------------------------------------------ the producers
    const int pt = threadIdx.x - kTConsumers;
    const int pw = pt >> 5, lane = pt & 31, g = lane >> 2, t = lane & 3;
    const int cw = pw & 3, hr = pw >> 2;  // column, 16-row group
    const int hl = a.hl, il = a.il;
    const uint32_t peer_as = map_shared(smem_u32(As), peer_rank);
    auto rows_p0 = [&](int item) {  // this block's rows of an item
      return item / a.ct * kTM + (int)rank * kTRows;
    };
    const int rl = (int)rank * kTRows + hr * kGateP;  // the warp's tile rows
    // wait until group gg's slot is free in both blocks
    auto wait_free = [&](int gg) {
      if (gg >= 2) mbar_wait_cluster(&a_empty[gg & 1], g_parity(gg) ^ 1);
    };
    // publish this block's rows of the n slabs of group gg: once every
    // producer's stores are fenced into the async proxy, the leader copies
    // them into the other block's slabs (completing there on its full
    // barrier) and arrives on this block's, expecting the other block's
    // rows by the same means
    auto publish = [&](int gg, int n) {
      fence_proxy_async();
      bar_sync(1, kTProducers);
      if (pt == 0) {
        const uint32_t pf = map_shared(smem_u32(&a_full[gg & 1]), peer_rank);
        for (int s = 0; s < n; ++s) {
          const int off = g_slab(gg, s) + (int)rank * kTRowsBytes;
          bulk_copy_to_peer(peer_as + off, As + off, kTRowsBytes, pf);
        }
        mbar_arrive_tx(&a_full[gg & 1], n * kTRowsBytes);
      }
    };
    if constexpr (KR > 0) {
      uint2* frag = reinterpret_cast<uint2*>(Hs);
      // staged: chunk cc's inte channels of item i's rows into buffer b
      auto stage_x = [&](int i, int cc, int b) {
        if constexpr (kTailStaged<KR>) {
          stage_inte(Is + b * kTRows * il, il, a, rows_p0(i), cc * kTC, pt);
          cp_async_commit();
        }
      };
      int buf = 0;
      if (cluster < a.items) stage_x(cluster, 0, 0);
      for (int item = cluster; item < a.items; item += clusters) {
        const int i = (item - cluster) / clusters;
        const int p0 = rows_p0(item) + hr * kGateP;  // the warp's rows
        const bool probe = a.g_probe != nullptr && item % a.ct == 0;
        // (the last item's last logits are behind every producer: its
        // publish synchronised them)
        make_frag(frag, a, rows_p0(item), pt);
        for (int cc = 0; cc < a.chunks; ++cc, buf ^= 1) {
          const int gg = g_index(i, cc, 0);
          const int cb = cc * kTC + cw * 8;  // the warp's column
          const int c = cb + 2 * t;
          GateThreadT<__nv_bfloat16> th;
          th.load(a.isc, a.ish, a.w2k, a.w2b, a.s2, a.t2, c, cb + g, t,
                  a.two_fin);
          cp_async_wait<0>();
          bar_sync(1, kTProducers);  // frag made, inte landed, the other
                                     // buffer read
          if (cc + 1 < a.chunks)
            stage_x(item, cc + 1, buf ^ 1);
          else if (item + clusters < a.items)
            stage_x(item + clusters, 0, buf ^ 1);
          float u[KR][4];
          const uint2* fr = frag + hr * a.k * 8 * 32;
#pragma unroll
          for (int s = 0; s < KR; ++s)
            if (kExact || s < a.k) th.logits_frag(fr + s * 8 * 32, lane, u[s]);
          if (a.softmax) softmax_slots<KR>(u, kExact ? KR : a.k);
          wait_free(gg);
#pragma unroll
          for (int s = 0; s < KR; ++s)
            if (kExact || s < a.k) {
              __nv_bfloat162 x[2];
              if constexpr (kTailStaged<KR>) {
                const __nv_bfloat16* xs = Is + buf * kTRows * il +
                                          (hr * kGateP + g) * il + cw * 8 +
                                          2 * t + s * kTC;
                x[0] = *reinterpret_cast<const __nv_bfloat162*>(xs);
                x[1] = *reinterpret_cast<const __nv_bfloat162*>(xs + 8 * il);
              } else {
                x[0] = load_inte(a, p0 + g, s, c);
                x[1] = load_inte(a, p0 + g + 8, s, c);
              }
              put_gate(a, th, As, g_slab(gg, s), rl, p0, s, cw, g, t, x,
                       u[s]);
            }
          if (probe)
            probe_gate(a, As, g_slab(gg, 0), rl, p0, 0, a.k, c, cw, g, t);
          publish(gg, a.k);
        }
      }
    } else {
      // per chunk, pass 1 the online maximum and normaliser of the warp's
      // positions over chunks of kGateChunk staged slots, pass 2 a group
      // at a time: logits recomputed, weights expf(u - m) / z
      __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(Hs);
      for (int item = cluster; item < a.items; item += clusters) {
        const int i = (item - cluster) / clusters;
        const int r0 = rows_p0(item);
        const int p0 = r0 + hr * kGateP;
        const bool probe = a.g_probe != nullptr && item % a.ct == 0;
        for (int cc = 0; cc < a.chunks; ++cc) {
          const int cb = cc * kTC + cw * 8;
          const int c = cb + 2 * t;
          GateThreadT<__nv_bfloat16> th;
          th.load(a.isc, a.ish, a.w2k, a.w2b, a.s2, a.t2, c, cb + g, t,
                  a.two_fin);
          // the staged slots [s0, s0 + ns) of the block's rows
          auto stage = [&](int s0, int ns) {
            bar_sync(1, kTProducers);  // the buffer is read
            stage_h(sh, hl, a.h, a.rows, a.k, r0, s0, ns, pt);
            cp_async_commit();
            cp_async_wait<0>();
            bar_sync(1, kTProducers);
          };
          float m[4], z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            m[q] = -INFINITY;
            z[q] = 0.f;
          }
          for (int s0 = 0; s0 < a.k && a.softmax; s0 += kGateChunk) {
            const int ns = min(kGateChunk, a.k - s0);
            stage(s0, ns);
            for (int s = 0; s < ns; ++s) {
              float u[4];
              th.logits(sh + hr * kGateP * hl + s * kHidden, hl, g, t, u);
#pragma unroll
              for (int q = 0; q < 4; ++q) online_softmax(m[q], z[q], u[q]);
            }
          }
          for (int s0 = 0; s0 < a.k; s0 += kTPass) {
            const int ns = min(kTPass, a.k - s0);
            const int gg = g_index(i, cc, s0 / kTPass);
            stage(s0, ns);
            wait_free(gg);
            for (int s = 0; s < ns; ++s) {
              float u[4];
              th.logits(sh + hr * kGateP * hl + s * kHidden, hl, g, t, u);
              if (a.softmax) {
#pragma unroll
                for (int q = 0; q < 4; ++q) u[q] = expf(u[q] - m[q]) / z[q];
              }
              const __nv_bfloat162 x[2] = {
                  load_inte(a, p0 + g, s0 + s, c),
                  load_inte(a, p0 + g + 8, s0 + s, c)};
              put_gate(a, th, As, g_slab(gg, s), rl, p0, s0 + s, cw, g, t, x,
                       u);
            }
            if (probe)
              probe_gate(a, As, g_slab(gg, 0), rl, p0, s0, ns, c, cw, g, t);
            publish(gg, ns);
          }
        }
      }
    }
    cp_async_wait<0>();
  } else {
    // ------------------------------------------------------- the consumers
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // wi positions: a stage a pair of slabs (the last of an item may hold
    // one); position p: item cluster + (p / np) * clusters, merge depth
    // (p % np) * kTBK, this block's columns (when they start inside 2F)
    const int np = (nslab + 1) / 2;
    const int my_items =
        cluster < a.items ? (a.items - 1 - cluster) / clusters + 1 : 0;
    const int total = my_items * np;
    auto load_b = [&](int p) {
      const int n0 = b_cols(cluster + p / np * clusters);
      if (n0 >= a.two_f) {  // no columns here: an empty stage
        mbar_arrive(rb.full_bar(p));
        return;
      }
      mbar_arrive_tx(rb.full_bar(p), kTBBytes);
      tma_load_2d(Bs + rb.stage(p) * kTBBytes, &map_wi, rb.full_bar(p),
                  p % np * kTBK, n0);
    };
    if (threadIdx.x == 0)
      for (int p = 0; p < a.b_stages && p < total; ++p) load_b(p);
    // position p's products are done in this warp: the last of the four
    // warps to get there (a count a stage) refills the stage with position
    // p + b_stages, so that no warp waits for the others
    auto done_b = [&](int p) {
      if (lane != 0) return;
      const int st = rb.stage(p);
      if (atomicAdd(&b_count[st], 1) == kTConsumers / 32 - 1) {
        b_count[st] = 0;
        fence_proxy_async();
        if (p + a.b_stages < total) load_b(p + a.b_stages);
      }
    };
    // group gg's products are done: free its slot in both blocks
    const uint32_t peer_empty = map_shared(smem_u32(a_empty), peer_rank);
    auto done_a = [&](int gg) {
      if (lane == 0) {
        const uint32_t e = (uint32_t)(gg & 1) * 8;
        mbar_arrive_remote(smem_u32(a_empty) + e);
        mbar_arrive_remote(peer_empty + e);
      }
    };
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int gg = 0;  // the launch's A group
    for (int item = cluster; item < a.items; item += clusters) {
      const int n0 = b_cols(item);
      const bool live = n0 < a.two_f;
      const int pb = (item - cluster) / clusters * np;  // its first stage
      int j = 0;  // the item's slab
      for (int cc = 0; cc < a.chunks; ++cc)
        for (int q = 0; q < a.k; q += a.gs, ++gg) {
          mbar_wait_cluster(&a_full[gg & 1], g_parity(gg));
          for (int s = 0; s < min(a.gs, a.k - q); ++s, ++j) {
            const int p = pb + j / 2;  // its wi position
            const bool first = (j & 1) == 0;
            // one wi stage only: the last pair's products done and its
            // stage refilled before the next pair is awaited
            const bool one = a.b_stages == 1 && first && j > 0;
            if (one) {
              if (live) wgmma_wait<0>();
              done_b(p - 1);
            }
            if (first) rb.wait_full(p);
            if (live) {
              const uint64_t da = sw64_desc(As + g_slab(gg, s));
              // the pair's first or second 64 bytes of each 128-byte row
              const uint64_t db =
                  sw128_desc(Bs + rb.stage(p) * kTBBytes) + 4 * (j & 1);
              wgmma_slab<kTC / 16>(acc, da, db, j > 0);
              wgmma_wait<1>();  // the previous slab's products are done
            }
            // the previous slab was the last of its pair, the last of its
            // group
            if (first && j > 0 && !one) done_b(p - 1);
            if (j > 0 && s == 0) done_a(gg - 1);
          }
        }
      wgmma_wait<0>();
      fence_regs(acc);
      done_b(pb + np - 1);
      done_a(gg - 1);
      if (!live) continue;
      // rows row0 and row0 + 8 of columns c0 + 8 i (+ 1): (partial + acc)
      // + bias, AddStoreTo's order; partial and the bias by read-only
      // loads, which the stores of y do not hold back
      const int row0 = item / a.ct * kTM + warp * 16 + g;
      const int c0 = n0 + 2 * t;
      const bool pairs = (a.two_f & 1) == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= a.rows) continue;
        const float* pr = a.partial + (size_t)row * a.two_f;
        __nv_bfloat16* yr = a.y + (size_t)row * a.two_f;
#pragma unroll
        for (int i = 0; i < kTN / 8; ++i) {
          const int c = c0 + 8 * i;
          if (c >= a.two_f) continue;
          const float a0 = acc[4 * i + 2 * half], a1 = acc[4 * i + 2 * half + 1];
          if (pairs) {
            const float2 pp = __ldg(reinterpret_cast<const float2*>(pr + c));
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + c));
            *reinterpret_cast<__nv_bfloat162*>(yr + c) =
                __floats2bfloat162_rn((pp.x + a0) + bb.x, (pp.y + a1) + bb.y);
          } else {
            store_as(yr + c, (__ldg(pr + c) + a0) + __ldg(a.bias + c));
            if (c + 1 < a.two_f)
              store_as(yr + c + 1,
                       (__ldg(pr + c + 1) + a1) + __ldg(a.bias + c + 1));
          }
        }
      }
    }
  }
  cluster_sync();  // no block leaves while the other may still reach it
}

// the rings and the staging for k: the A ring's two groups, the staging
// (the h fragments, or 32 staged rows; staged, also two inte buffers) and
// as many wi stages as fit beside them, up to 4
inline bool tail_bf16_layout(TailBf16Args& a, bool staged, int& smem) {
  const int kc = a.k < kGateChunk ? a.k : kGateChunk;
  a.gs = a.k <= kGateChunk ? a.k : kTPass;
  a.hl = kc * kHidden + 8;
  a.il = a.k * kTC + 8;
  const int hbytes = a.k <= kGateChunk
                         ? a.k * (kTRows / kGateP) * 8 * 32 * 8
                         : kTRows * a.hl * 2;
  const int sbytes = hbytes + (staged ? 2 * kTRows * a.il * 2 : 0);
  const int rest =
      kTSmemMax - 1024 - kTBarBytes - sbytes - 2 * a.gs * kTABytes;
  a.b_stages = rest / kTBBytes < 4 ? rest / kTBBytes : 4;
  smem = 1024 + 2 * a.gs * kTABytes + a.b_stages * kTBBytes + kTBarBytes +
         sbytes;
  return a.b_stages >= 1;
}

template <int KR, bool kExact>
cudaError_t launch_tail_bf16(const CUtensorMap& map, TailBf16Args a,
                             int grid, cudaStream_t stream) {
  int smem = 0;
  if (!tail_bf16_layout(a, kTailStaged<KR>, smem))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tail_bf16_kernel<KR, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tail_bf16_kernel<KR, kExact><<<grid, kTThreads, smem, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// partial (rows, 2F); inte (rows, k/2*4Fin); h (rows, k*64), 16-byte
// aligned, or null for the plain stage; wi (ldg, ldw) with ldg = k/2*4Fin
// and ldw = 2F, each rounded up to 4 (zero pad rows and columns), 16-byte
// aligned; g scratch (rows, ldg), 16-byte aligned; y (rows, 2F). The gated
// stage needs 4Fin = 2 * 2Fin even.
int pdgn_bilateral_tail(const float* partial, const float* inte,
                        const float* h, const float* isc, const float* ish,
                        const float* w2k, const float* w2b, const float* s2,
                        const float* t2, const float* wi, int ldw,
                        const float* bias, int rows, int k, int four_fin,
                        int two_f, int ldg, int softmax, float* g, float* y,
                        cudaStream_t stream) {
  return bilateral_tail<float, RowsA>(partial, inte, h, isc, ish, w2k, w2b,
                                      s2, t2, wi, ldw, bias, rows, k,
                                      four_fin, two_f, ldg, softmax, g, y,
                                      stream);
}

// The plain bf16 stage (the gated stage is pdgn_bilateral_tail_gated_bf16):
// plain_gate_kernel, then the merge on the core's bf16 instance. partial
// (rows, 2F) fp32; inte (rows, k/2*4Fin) bf16; isc, ish (4Fin) fp32; wi
// (ldg, ldw) bf16 with ldg >= k/2*4Fin and ldw >= 2F multiples of 8 (16-
// byte granules of 8), its pad rows and columns zero, 16-byte aligned; bias
// (2F) fp32; g scratch (rows, ldg) bf16, 16-byte aligned; y (rows, 2F) bf16.
int pdgn_bilateral_tail_plain_bf16(const float* partial,
                                   const __nv_bfloat16* inte,
                                   const float* isc, const float* ish,
                                   const __nv_bfloat16* wi, int ldw,
                                   const float* bias, int rows, int k,
                                   int four_fin, int two_f, int ldg,
                                   __nv_bfloat16* g, __nv_bfloat16* y,
                                   cudaStream_t stream) {
  const int K = (k / 2) * four_fin;
  if (k < 2 || k % 2 || ldg < K || ldg % 8 || ldw < two_f || ldw % 8)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * ldg;
  plain_gate_kernel<__nv_bfloat16><<<(unsigned)((total + 255) / 256), 256, 0,
                                     stream>>>(inte, isc, ish, rows, K, ldg,
                                               four_fin, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)tc_gemm<false, kGFold>(
      RowsBf16{g, ldg}, wi, ldw, rows, two_f, ldg, ldg,
      AddStoreTo<__nv_bfloat16>{y, partial, bias, two_f, two_f}, stream);
}

// The bf16 gated stage in one launch (tail_bf16_kernel): partial (rows,
// two_f) fp32; inte (rows, k * two_fin), h (rows, k * 64) and w2k (64,
// two_fin) bf16, inte and h 16-byte aligned; isc, ish (2 * two_fin) and
// w2b, s2, t2 (two_fin) fp32; wi_packed (two_f, chunks * k * 32) bf16, 16-
// byte aligned, chunks = ceil(two_fin / 32) (pack_tail_wi_bf16's layout);
// bias (two_f) fp32; y (rows, two_f) bf16; g_probe null, or (rows, k *
// two_fin) bf16 to receive the gate values; grid: the card's SMs (clusters
// of two blocks, at most one a 64-row tile). Even k, 2 <= k <= 126.
int pdgn_bilateral_tail_gated_bf16(
    const float* partial, const __nv_bfloat16* inte, const __nv_bfloat16* h,
    const float* isc, const float* ish, const __nv_bfloat16* w2k,
    const float* w2b, const float* s2, const float* t2,
    const __nv_bfloat16* wi_packed, const float* bias, int rows, int k,
    int two_fin, int two_f, int softmax, int grid, __nv_bfloat16* g_probe,
    __nv_bfloat16* y, cudaStream_t stream) {
  if (k < 2 || k % 2 || k > kGateMaxK || two_fin < 1 || two_f < 1 ||
      rows < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  TailBf16Args a{partial, inte, h, isc, ish, w2k, w2b, s2, t2, bias, y,
                 g_probe, rows, k, two_fin, two_f, softmax};
  a.chunks = (two_fin + kTC - 1) / kTC;
  a.ct = (two_f + kTNI - 1) / kTNI;
  const long long items = (long long)((rows + kTM - 1) / kTM) * a.ct;
  const long long slabs = items * a.chunks * k;
  if (slabs >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  const long long kp = (long long)a.chunks * k * kTC;
  CUtensorMap map;
  cudaError_t err =
      bf16_tile_map(&map, wi_packed, two_f, kp, kp, kTN, kTBK);
  if (err != cudaSuccess) return (int)err;
  // clusters of two blocks, one a tile at a time
  grid = 2 * (grid / 2 < a.items ? grid / 2 : a.items);
  if (grid < 2) grid = 2;
  if (k == 10)
    err = launch_tail_bf16<10, true>(map, a, grid, stream);
  else if (k < 10)
    err = launch_tail_bf16<10, false>(map, a, grid, stream);
  else if (k <= kGateChunk)
    err = launch_tail_bf16<kGateChunk, false>(map, a, grid, stream);
  else
    err = launch_tail_bf16<0, false>(map, a, grid, stream);
  return (int)err;
}

}  // extern "C"
