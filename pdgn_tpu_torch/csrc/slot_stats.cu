// Slot moment statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/slot_stats.py::_kernel
// (launcher _pallas_stats): over every (batch, point, slot) row of the
// lane-flat hidden activation h (B, N, k*64), the channel sums s = sum h and
// the second-moment matrix S = sum h h^T that give bn_all2's statistics
// through the linear identity.
//
// What bounds it on the H100: bytes. At stage 4, B=128, h is 1,310,720 rows
// of 64 fp32 (335 MB, 0.100 ms at 3.35 TB/s), and S = h^T h is a tall-skinny
// product of depth 1.3 M rows: 10.7 GFLOP, three times over in 3xTF32, is
// 0.065 ms at the tensor cores' 495 TFLOP/s. Every element of h is read
// once.
//
// The design: a persistent grid (one block of 8 warps per SM). Each warp
// owns a contiguous range of rows and streams it through its own 4-stage
// ring of 16-row cp.async stages in shared memory, so loads overlap the
// products. Per 8 rows a lane reads two float4s of each of its two rows
// (granules XOR-swizzled, so a quarter-warp hits 32 banks); the 16 values
// are the A fragments (h^T) and the B fragments (h) at once, under a fixed
// permutation of the channels, are split into TF32 hi/lo once, and feed
// the 20 (16 x 8) tiles of S's upper triangle by mma_tf32x3
// (mma_tf32x3.cuh): 60 tensor-core products per 8 rows instead of 96 for
// the full matrix. The tensor cores truncate their additions, so the mma
// accumulators restart every 32 rows and fold into fp32 totals by rounded
// adds. s rides the same pass in fp32 adds. At the end the warps' partials
// fold in shared memory in a fixed order, each block writes one partial (S
// mirrored from its upper triangle, so exactly symmetric, then s), and
// column_reduce adds the ~132 block partials in a fixed order: the
// statistics are deterministic.
//
// The bf16 instance (pdgn_slot_stats_bf16; the TPU kernel on the bf16 h of
// --compute_dtype bfloat16, slot_stats.py:15-16) is the same kernel on
// 16-bit rows: half the bytes, a 16-byte granule of 8 channels a lane a
// row (granules XOR-swizzled by 2 (row % 4), so a quarter-warp's 8
// granules of 4 rows hit 32 banks), and one TF32 pass a product: a bf16
// value is exact in TF32, so hi = the value, lo = 0 and each product is
// exact; s and S accumulate in fp32 as the fp32 instance's.
#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kH = 64;
constexpr int kSWarps = 8;
constexpr int kSThreads = kSWarps * 32;
constexpr int kSRows = 16;              // rows per ring stage: two k8 steps
constexpr int kSStages = 4;
constexpr int kFold = 2;                // stages between accumulator folds
constexpr int kStageFloats = kSRows * kH;  // elements a stage
constexpr int kWarpRing = kSStages * kStageFloats;
constexpr int kTiles = 20;              // (m16, n8) tiles with n >= 2m
constexpr int kOut = kH * kH + kH;      // [S row-major | s]
// the rings, then the warps' partials in the same memory: 133,120 bytes
constexpr int kSSmemBytes = (kSWarps * kWarpRing > kSWarps * kOut
                                 ? kSWarps * kWarpRing
                                 : kSWarps * kOut) * 4;

// A row's 16-byte granule q sits at q ^ swz(row): the 8 lanes of a
// quarter-warp (two g, four t) then read 8 distinct bank groups. fp32 rows
// hold 16 granules (a lane reads 2g and 2g + 1), bf16 rows 8 (a lane reads
// g).
template <class T>
__device__ __forceinline__ int swz(int row) {
  if constexpr (sizeof(T) == 2) return (row & 3) << 1;
  return (row & 1) | ((row & 2) << 1);
}

// one stage: rows [r0, r0 + 16) of h, rows at or past r1 zero-filled
template <class T>
__device__ __forceinline__ void load_rows(T* stage, const T* h, long long r0,
                                          long long r1, int lane) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a granule
  constexpr int G = kH / V;               // granules a row
#pragma unroll
  for (int i = 0; i < kSRows * G / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / G, q = e % G;
    const long long gr = r0 + r;
    const bool ok = gr < r1;
    cp_async16(stage + r * kH + V * (q ^ swz<T>(r)),
               ok ? h + gr * kH + V * q : h, ok ? 16 : 0);
  }
}

// Fragment positions are a permutation of the channels: lane (g, t) loads
// channels 8g..8g+7 of its two rows as two float4s, and v[q] = channel
// 8g + q stands at position 8q + g (pos(c) = 8 (c % 8) + c / 8), so the
// fragments need 4 shared loads per k8 step instead of 16. The products'
// upper triangle in positions covers every channel pair once.
__device__ __forceinline__ int pos(int c) { return 8 * (c & 7) + (c >> 3); }

template <class T>
__global__ void __launch_bounds__(kSThreads, 1)
slot_stats_kernel(const T* __restrict__ h, long long rows,
                  long long rows_per_warp, float* __restrict__ scratch) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* ring = reinterpret_cast<T*>(smem) + warp * kWarpRing;
  const long long r0 =
      ((long long)blockIdx.x * kSWarps + warp) * rows_per_warp;
  long long r1 = r0 + rows_per_warp;
  if (r1 > rows) r1 = rows;
  const int chunks = r1 > r0 ? (int)((r1 - r0 + kSRows - 1) / kSRows) : 0;

  // The tensor cores truncate their additions, so a long chain of mma
  // accumulations drifts (~1e-5 over 1,248 rows): part takes kFold stages
  // and is folded into total by rounded fp32 adds.
  float total[kTiles][4], part[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = part[i][j] = 0.f;
  float colsum[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) colsum[q] = 0.f;

#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < chunks)
      load_rows(ring + s * kStageFloats, h, r0 + s * kSRows, r1, lane);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kSStages - 2>();
    __syncwarp();
    const int nc = c + kSStages - 1;  // refills the stage read at c - 1
    if (nc < chunks)
      load_rows(ring + (nc % kSStages) * kStageFloats, h,
                r0 + (long long)nc * kSRows, r1, lane);
    cp_async_commit();
    const T* st = ring + (c % kSStages) * kStageFloats;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // v0 = channels 8g..8g+7 of row t of this k8 step, v1 of row t + 4:
      // a0/a1/a2/a3 of m-tile mi are v0[2mi], v0[2mi+1], v1[2mi],
      // v1[2mi+1]; b0/b1 of n-tile nj are v0[nj], v1[nj]
      float v0[8], v1[8];
      const int ra = ks * 8 + t, rb = ra + 4;
      if constexpr (kBf16) {
        const uint4 a = reinterpret_cast<const uint4*>(
            st + ra * kH)[g ^ swz<T>(ra)];
        const uint4 b = reinterpret_cast<const uint4*>(
            st + rb * kH)[g ^ swz<T>(rb)];
        const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
        const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // the low half is the lower channel
          v0[2 * q] = __uint_as_float(wa[q] << 16);
          v0[2 * q + 1] = __uint_as_float(wa[q] & 0xffff0000u);
          v1[2 * q] = __uint_as_float(wb[q] << 16);
          v1[2 * q + 1] = __uint_as_float(wb[q] & 0xffff0000u);
        }
      } else {
        const float4* pa = reinterpret_cast<const float4*>(st + ra * kH);
        const float4* pb = reinterpret_cast<const float4*>(st + rb * kH);
        const float4 a0 = pa[(2 * g) ^ swz<T>(ra)];
        const float4 a1 = pa[(2 * g + 1) ^ swz<T>(ra)];
        const float4 b0 = pb[(2 * g) ^ swz<T>(rb)];
        const float4 b1 = pb[(2 * g + 1) ^ swz<T>(rb)];
        v0[0] = a0.x; v0[1] = a0.y; v0[2] = a0.z; v0[3] = a0.w;
        v0[4] = a1.x; v0[5] = a1.y; v0[6] = a1.z; v0[7] = a1.w;
        v1[0] = b0.x; v1[1] = b0.y; v1[2] = b0.z; v1[3] = b0.w;
        v1[4] = b1.x; v1[5] = b1.y; v1[6] = b1.z; v1[7] = b1.w;
      }
      uint32_t hi0[8], lo0[8], hi1[8], lo1[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        colsum[q] += v0[q];
        colsum[q] += v1[q];
        if constexpr (kBf16) {  // exact in TF32: no low half
          hi0[q] = __float_as_uint(v0[q]);
          hi1[q] = __float_as_uint(v1[q]);
          lo0[q] = lo1[q] = 0u;
        } else {
          split_tf32(v0[q], hi0[q], lo0[q]);
          split_tf32(v1[q], hi1[q], lo1[q]);
        }
      }
      int tile = 0;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint32_t ahi[4] = {hi0[2 * mi], hi0[2 * mi + 1], hi1[2 * mi],
                                 hi1[2 * mi + 1]};
        const uint32_t alo[4] = {lo0[2 * mi], lo0[2 * mi + 1], lo1[2 * mi],
                                 lo1[2 * mi + 1]};
#pragma unroll
        for (int nj = 2 * mi; nj < 8; ++nj, ++tile) {
          const uint32_t bhi[2] = {hi0[nj], hi1[nj]};
          const uint32_t blo[2] = {lo0[nj], lo1[nj]};
          if constexpr (kBf16)
            mma_tf32(part[tile], ahi, bhi);
          else
            mma_tf32x3(part[tile], ahi, alo, bhi, blo);
        }
      }
    }
    if (c % kFold == kFold - 1 || c == chunks - 1) {
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the partials take its place

  float* red = smem + warp * kOut;  // this warp's [S in positions | s]
  {
    int tile = 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 2 * mi; nj < 8; ++nj, ++tile) {
        const int r = 16 * mi + g, c = 8 * nj + 2 * t;
        red[r * kH + c] = total[tile][0];
        red[r * kH + c + 1] = total[tile][1];
        red[(r + 8) * kH + c] = total[tile][2];
        red[(r + 8) * kH + c + 1] = total[tile][3];
      }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v = colsum[q];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[kH * kH + 8 * g + q] = v;
  }
  __syncthreads();

  float* o = scratch + (size_t)blockIdx.x * kOut;
  for (int e = threadIdx.x; e < kOut; e += kSThreads) {
    int src = e;
    if (e < kH * kH) {  // S[i][j] from the upper triangle in positions
      const int pi = pos(e / kH), pj = pos(e % kH);
      src = pi <= pj ? pi * kH + pj : pj * kH + pi;
    }
    float v = 0.f;
    for (int w = 0; w < kSWarps; ++w) v += smem[w * kOut + src];
    o[e] = v;
  }
}

template <class T>
int slot_stats(const T* h, long long rows, int nblk, float* scratch,
               float* out, cudaStream_t stream) {
  if (nblk < 1) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)nblk * kSWarps;
  const long long rows_per_warp =
      ((rows + warps - 1) / warps + kSRows - 1) / kSRows * kSRows;
  cudaError_t err = cudaFuncSetAttribute(
      slot_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSSmemBytes);
  if (err != cudaSuccess) return (int)err;
  slot_stats_kernel<T><<<nblk, kSThreads, kSSmemBytes, stream>>>(
      h, rows, rows_per_warp, scratch);
  PDGN_CHECK_LAUNCH();
  column_reduce(scratch, nblk, kOut, out, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// h: (rows, 64) fp32, 16-byte aligned; nblk blocks of 8 warps, each warp
// taking a contiguous range of whole stages; scratch: (nblk, 64*64 + 64);
// out: (64*64 + 64) = [S row-major | s].
int pdgn_slot_stats(const float* h, long long rows, int nblk, float* scratch,
                    float* out, cudaStream_t stream) {
  return slot_stats(h, rows, nblk, scratch, out, stream);
}

// The bf16 instance: h (rows, 64) bf16, 16-byte aligned; the rest as
// pdgn_slot_stats.
int pdgn_slot_stats_bf16(const __nv_bfloat16* h, long long rows, int nblk,
                         float* scratch, float* out, cudaStream_t stream) {
  return slot_stats(h, rows, nblk, scratch, out, stream);
}

}  // extern "C"
