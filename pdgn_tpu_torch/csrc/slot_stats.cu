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
// --compute_dtype bfloat16, slot_stats.py:15-16), redesigned as a stream.
// Bound: bytes again, 168 MB at stage 4, B=128 (0.050 ms at 3.35 TB/s); its
// products (S's upper triangle and s, 11 GFLOP of exact bf16 products) take
// a few microseconds of the tensor cores. So the design keeps as many bytes
// in flight as the SM holds and spends little issue on each row:
//   - a persistent grid, one block an SM, each block a contiguous range of
//     whole 128-row stages; one producer lane streams them by TMA
//     (cp.async.bulk.tensor, 16 KB a box, 128-byte swizzle) into an
//     8-stage ring (128 KB in flight an SM) with full/empty mbarriers;
//   - 8 consumer warps take 16 rows of each stage: four ldmatrix.x4.trans
//     give the 16 fragments (8 channel blocks x 2 row halves) that are the
//     A operand (h^T) and the B operand (h) of m16n8k16 bf16 mma.sync at
//     once (conflict-free under the swizzle), and the warp releases the
//     stage before its products;
//   - 20 products for S's upper triangle and 4 against a ones operand for s
//     (exact: bf16 products are exact in fp32, 1 is exact), each mma from a
//     zero accumulator (16 rows, a single tensor-core sum) added to fp32
//     totals by rounded adds: the fold comes every 16 rows, so no chain of
//     truncated tensor-core additions grows;
//   - the warps' totals fold in a fixed order as the fp32 instance's, S
//     from its upper triangle (exactly symmetric), and partials_reduce adds
//     the block partials in a fixed order, 32 columns a block.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kH = 64;
constexpr int kSWarps = 8;
constexpr int kSThreads = kSWarps * 32;
constexpr int kSRows = 16;              // rows per ring stage: two k8 steps
constexpr int kSStages = 4;
constexpr int kFold = 2;                // stages between accumulator folds
constexpr int kStageFloats = kSRows * kH;
constexpr int kWarpRing = kSStages * kStageFloats;
constexpr int kTiles = 20;              // (m16, n8) tiles with n >= 2m
constexpr int kOut = kH * kH + kH;      // [S row-major | s]
// the rings, then the warps' partials in the same memory: 133,120 bytes
constexpr int kSSmemBytes = (kSWarps * kWarpRing > kSWarps * kOut
                                 ? kSWarps * kWarpRing
                                 : kSWarps * kOut) * 4;

// A row's 16-byte granule q sits at q ^ swz(row): the 8 lanes of a
// quarter-warp (two g, four t) then read 8 distinct bank groups.
__device__ __forceinline__ int swz(int row) {
  return (row & 1) | ((row & 2) << 1);
}

// one stage: rows [r0, r0 + 16) of h, rows at or past r1 zero-filled
__device__ __forceinline__ void load_rows(float* stage, const float* h,
                                          long long r0, long long r1,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < kSRows * kH / 4 / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e >> 4, q = e & 15;
    const long long gr = r0 + r;
    const bool ok = gr < r1;
    cp_async16(stage + r * kH + 4 * (q ^ swz(r)),
               ok ? h + gr * kH + 4 * q : h, ok ? 16 : 0);
  }
}

// Fragment positions are a permutation of the channels: lane (g, t) loads
// channels 8g..8g+7 of its two rows as two float4s, and v[q] = channel
// 8g + q stands at position 8q + g (pos(c) = 8 (c % 8) + c / 8), so the
// fragments need 4 shared loads per k8 step instead of 16. The products'
// upper triangle in positions covers every channel pair once.
__device__ __forceinline__ int pos(int c) { return 8 * (c & 7) + (c >> 3); }

__global__ void __launch_bounds__(kSThreads, 1)
slot_stats_kernel(const float* __restrict__ h, long long rows,
                  long long rows_per_warp, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* ring = smem + warp * kWarpRing;
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
    const float* st = ring + (c % kSStages) * kStageFloats;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // v0 = channels 8g..8g+7 of row t of this k8 step, v1 of row t + 4:
      // a0/a1/a2/a3 of m-tile mi are v0[2mi], v0[2mi+1], v1[2mi],
      // v1[2mi+1]; b0/b1 of n-tile nj are v0[nj], v1[nj]
      float v0[8], v1[8];
      {
        const int ra = ks * 8 + t, rb = ra + 4;
        const float4* pa = reinterpret_cast<const float4*>(st + ra * kH);
        const float4* pb = reinterpret_cast<const float4*>(st + rb * kH);
        const float4 a0 = pa[(2 * g) ^ swz(ra)];
        const float4 a1 = pa[(2 * g + 1) ^ swz(ra)];
        const float4 b0 = pb[(2 * g) ^ swz(rb)];
        const float4 b1 = pb[(2 * g + 1) ^ swz(rb)];
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
        split_tf32(v0[q], hi0[q], lo0[q]);
        split_tf32(v1[q], hi1[q], lo1[q]);
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

// ---------------------------------------------- the bf16 instance (Hopper)
constexpr int kBRows = 128;                   // rows a stage: one TMA box
constexpr int kBStages = 8;
constexpr int kBWarps = kBRows / 16;          // consumer warps, 16 rows each
constexpr int kBThreads = (kBWarps + 1) * 32;  // and one producer warp
constexpr int kBStage = kBRows * kH * 2;      // bytes a stage (16 KB)
constexpr int kBTiles = kTiles + 4;           // S's 20 tiles, then s's 4
// the ring, whose memory the warps' partials take at the end, then the
// barriers; 1024 bytes to align the ring
constexpr int kBBars = kBStages * kBStage > kBWarps * kOut * 4
                           ? kBStages * kBStage
                           : kBWarps * kOut * 4;
constexpr int kBSmemBytes = 1024 + kBBars + 2 * kBStages * 8;

// four 8x8 bf16 matrices of shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of each matrix m, the
// elements (rows 2t, 2t + 1; column g) in r[m]
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// d = a b from a zero accumulator (m16n8k16, bf16 operands, fp32 result)
__device__ __forceinline__ void mma_bf16_from0(float d[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__global__ void __launch_bounds__(kBThreads, 1)
slot_stats_bf16_kernel(const __grid_constant__ CUtensorMap map,
                       long long rows, long long rows_per_block,
                       float* __restrict__ scratch) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBBars);
  uint64_t* empty = full + kBStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block
                                                  : rows;
  const int stages = r1 > r0 ? (int)((r1 - r0 + kBRows - 1) / kBRows) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float tot[kBTiles][4];
#pragma unroll
  for (int i = 0; i < kBTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.f;

  if (warp == kBWarps) {  // the producer: one lane streams the stages
    if (lane == 0) {
      for (int c = 0; c < stages; ++c) {
        const int st = c % kBStages;
        if (c >= kBStages) mbar_wait(&empty[st], ((c / kBStages) & 1) ^ 1);
        mbar_arrive_tx(&full[st], kBStage);
        tma_load_2d(ring + st * kBStage, &map, &full[st], 0,
                    (int)(r0 + (long long)c * kBRows));
      }
    }
    __syncwarp();
  } else {
    // fragment f[2i + (m & 1)][m >> 1] of matrix m of load i: channels
    // 8 (2i + (m & 1)) .. + 7 of rows 8 (m >> 1) .. + 7 of the warp's 16
    const int m = lane >> 3, rr = 8 * (m >> 1) + (lane & 7);
    const uint32_t ones = 0x3F803F80u;  // two bf16 1.0
    for (int c = 0; c < stages; ++c) {
      const int st = c % kBStages;
      mbar_wait(&full[st], (c / kBStages) & 1);
      __syncwarp();
      const uint8_t* rows16 = ring + st * kBStage + warp * 16 * kH * 2;
      uint32_t f[8][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t r[4];
        const int c8 = 2 * i + (m & 1);
        ldsm_x4_trans(r, rows16 + rr * kH * 2 +
                             ((c8 ^ swizzle_row(rr)) << 4));
        f[2 * i][0] = r[0];
        f[2 * i + 1][0] = r[1];
        f[2 * i][1] = r[2];
        f[2 * i + 1][1] = r[3];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      int tile = 0;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A (16 channels x 16 rows) of m-tile mi; B of n-tile nj is
        // (f[nj][0], f[nj][1])
        const uint32_t a[4] = {f[2 * mi][0], f[2 * mi + 1][0], f[2 * mi][1],
                               f[2 * mi + 1][1]};
        float d[4];
#pragma unroll
        for (int nj = 2 * mi; nj < 8; ++nj, ++tile) {
          mma_bf16_from0(d, a, f[nj][0], f[nj][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) tot[tile][q] += d[q];
        }
        mma_bf16_from0(d, a, ones, ones);
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[kTiles + mi][q] += d[q];
      }
    }
  }
  __syncthreads();  // every stage is consumed: the partials take the ring

  float* red = reinterpret_cast<float*>(ring);
  if (warp < kBWarps) {
    float* mine = red + warp * kOut;  // [S upper triangle | s]
    int tile = 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int nj = 2 * mi; nj < 8; ++nj, ++tile) {
        const int r = 16 * mi + g, c = 8 * nj + 2 * t;
        mine[r * kH + c] = tot[tile][0];
        mine[r * kH + c + 1] = tot[tile][1];
        mine[(r + 8) * kH + c] = tot[tile][2];
        mine[(r + 8) * kH + c + 1] = tot[tile][3];
      }
      // column 2t of the ones product: the sums of channels 16mi + g, + 8
      if (t == 0) {
        mine[kH * kH + 16 * mi + g] = tot[kTiles + mi][0];
        mine[kH * kH + 16 * mi + 8 + g] = tot[kTiles + mi][2];
      }
    }
  }
  __syncthreads();

  float* o = scratch + (size_t)blockIdx.x * kOut;
  for (int e = threadIdx.x; e < kOut; e += kBThreads) {
    int src = e;
    if (e < kH * kH) {  // S[i][j] from the upper triangle
      const int i = e / kH, j = e % kH;
      src = i <= j ? e : j * kH + i;
    }
    float v = 0.f;
    for (int w = 0; w < kBWarps; ++w) v += red[w * kOut + src];
    o[e] = v;
  }
}

// out[c] = sum over the nblk partials (rows) of in[:, c], fixed order: a
// block takes 32 columns, warp w the rows w, w + 8, .. in ascending order,
// then warp 0 adds the 8 warps' sums in order. Lanes read neighbouring
// columns, so each row of a block is one 128-byte line.
__global__ void __launch_bounds__(256)
partials_reduce_kernel(const float* __restrict__ in, int nblk, int ncol,
                       float* __restrict__ out) {
  __shared__ float part[8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (c < ncol)
    for (int b = warp; b < nblk; b += 8) v += in[(size_t)b * ncol + c];
  part[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < ncol) {
    float s = part[0][lane];
    for (int w = 1; w < 8; ++w) s += part[w][lane];
    out[c] = s;
  }
}

}  // namespace

extern "C" {

// h: (rows, 64) fp32, 16-byte aligned; nblk blocks of 8 warps, each warp
// taking a contiguous range of whole stages; scratch: (nblk, 64*64 + 64);
// out: (64*64 + 64) = [S row-major | s].
int pdgn_slot_stats(const float* h, long long rows, int nblk, float* scratch,
                    float* out, cudaStream_t stream) {
  if (nblk < 1) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)nblk * kSWarps;
  const long long rows_per_warp =
      ((rows + warps - 1) / warps + kSRows - 1) / kSRows * kSRows;
  cudaError_t err = cudaFuncSetAttribute(
      slot_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSSmemBytes);
  if (err != cudaSuccess) return (int)err;
  slot_stats_kernel<<<nblk, kSThreads, kSSmemBytes, stream>>>(
      h, rows, rows_per_warp, scratch);
  PDGN_CHECK_LAUNCH();
  column_reduce(scratch, nblk, kOut, out, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

// The bf16 instance: h (rows, 64) bf16, 16-byte aligned, 1 <= rows <
// 2^31; nblk blocks, each a contiguous range of whole 128-row stages; the
// rest as pdgn_slot_stats.
int pdgn_slot_stats_bf16(const __nv_bfloat16* h, long long rows, int nblk,
                         float* scratch, float* out, cudaStream_t stream) {
  if (nblk < 1 || rows < 1 || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long rows_per_block =
      ((rows + nblk - 1) / nblk + kBRows - 1) / kBRows * kBRows;
  CUtensorMap map;
  cudaError_t err = bf16_tile_map(&map, h, rows, kH, kH, kBRows);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(slot_stats_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBSmemBytes);
  if (err != cudaSuccess) return (int)err;
  slot_stats_bf16_kernel<<<nblk, kBThreads, kBSmemBytes, stream>>>(
      map, rows, rows_per_block, scratch);
  PDGN_CHECK_LAUNCH();
  partials_reduce_kernel<<<(kOut + 31) / 32, 256, 0, stream>>>(scratch, nblk,
                                                               kOut, out);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
