// Slot moment statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/slot_stats.py::_kernel
// (launcher _pallas_stats): over every (batch, point, slot) row of the
// lane-flat hidden activation h (B, N, k*64), the channel sums s = sum h and
// the second-moment matrix S = sum h h^T that give bn_all2's statistics
// through the linear identity.
//
// What bounds it on the H100: at stage 4 h is 128*1024*10 rows of 64 fp32
// (335 MB, 0.100 ms at 3.35 TB/s). S is symmetric, so the work is 64*65/2
// distinct dot products plus 64 adds, 64*65 + 64 FLOP per row (5.5 GFLOP,
// 0.083 ms at 67 TFLOP/s fp32): memory is the bound (each element of h is
// read once). This simple design computes the full 64x64 product, about
// twice the needed FLOP (0.16 ms at peak): computing one triangle would
// bring its own floor down to the memory time.
//
// The simple design: h is a contiguous (rows, 64) matrix. Each block takes
// 1024 rows, stages 32 of them at a time in shared memory and accumulates
// its 64x64 S (a 4x4 strided micro-tile per thread) and its 64 sums in
// fp32 registers; the per-block partials go to scratch and column_reduce adds
// them in a fixed order, so the statistics are deterministic.
#include "common.cuh"

namespace {

constexpr int kH = 64;
constexpr int kRowsPerBlock = 1024;
constexpr int kChunk = 32;

__global__ void __launch_bounds__(256)
slot_stats_kernel(const float* __restrict__ h, long long rows,
                  float* __restrict__ scratch) {
  __shared__ float sh[kChunk][kH];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long r0 = (long long)blockIdx.x * kRowsPerBlock;
  long long r1 = r0 + kRowsPerBlock;
  if (r1 > rows) r1 = rows;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float colsum = 0.f;

  for (long long c0 = r0; c0 < r1; c0 += kChunk) {
#pragma unroll
    for (int q = 0; q < kChunk * kH / 256; ++q) {
      int e = tid + q * 256;
      int r = e / kH, c = e % kH;
      long long gr = c0 + r;
      sh[r][c] = gr < r1 ? h[gr * kH + c] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kChunk; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sh[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sh[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (tid < kH) colsum += sh[r][tid];
    }
    __syncthreads();
  }

  float* o = scratch + (size_t)blockIdx.x * (kH * kH + kH);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[(ty + 16 * i) * kH + tx + 16 * j] = acc[i][j];
  if (tid < kH) o[kH * kH + tid] = colsum;
}

}  // namespace

extern "C" {

// h: (rows, 64) fp32; scratch: (ceil(rows / 1024), 64*64 + 64);
// out: (64*64 + 64) = [S row-major | s].
int pdgn_slot_stats(const float* h, long long rows, float* scratch, float* out,
                    cudaStream_t stream) {
  int nblk = (int)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  slot_stats_kernel<<<nblk, 256, 0, stream>>>(h, rows, scratch);
  PDGN_CHECK_LAUNCH();
  column_reduce(scratch, nblk, kH * kH + kH, out, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
