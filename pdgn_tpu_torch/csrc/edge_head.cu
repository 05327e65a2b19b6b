// Edge-conv stage head for Hopper (sm_90a).
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/edge_head.py::_head_kernel
// (launcher _head_pallas): self-kNN with the row minimum dropped, neighbour
// gathers, the window convolution in block channel order, the merge conv's
// fp32 partial, the gated stages' weight-net gather, and the batch-norm sums
// of all of them.
//
// What bounds it on the H100: operations. At stage 4 (N=1024, C=128, 4Fin=1024,
// 2F=512) one cloud costs ~8.1 GFLOP of window conv, ~1.5 GFLOP of merge
// partial and ~0.5 GFLOP of kNN distances against ~40 MB of traffic, so the
// fp32 FMA rate (67 TFLOP/s) is the ceiling.
//
// The simple design: several plain launches instead of one fused body.
//   1. knn_select (knn.cu, the knn_topk kernel's selection): self-kNN of
//      x_knn for k+1 by the fp32 norm expansion, ascending, lowest index
//      first on ties, slot 0 dropped. The TPU's packed bf16 keys are not
//      ported: the graph is the fp32-exact one.
//   2. gemm_kernel with a gathered A operand, twice: once for the window conv
//      (A row (n, wp) = [x[idx[n, wp..wp+window-1]] | x[n]], W = [wn; conv_a]),
//      once for the merge partial (A row n = [x[idx[n, :]] | x[n]],
//      W = [wen; a_merge]). Rows are read straight from device memory by index:
//      Hopper has indexed loads, so the TPU's one-hot MXU gathers are gone.
//   3. wnet_kernel: the 32-channel weight-net gather in the generator's
//      (window, j) slot order, plus its sums.
//   4. Batch-norm sums go per block into scratch and column_reduce adds them
//      in a fixed order (deterministic statistics).
#include "common.cuh"
#include "knn.cuh"

#include <math.h>

namespace {

// A row (p, r) with p = b*N + n: slot s < S reads x[b, idx[p, r + s], :],
// the last slot reads x[p, :] itself (the central term rides the product).
struct GatherA {
  const float* x;
  const int* idx;
  int N, C, k, R, S;
  __device__ __forceinline__ float load(int row, int kk) const {
    int s = kk / C, c = kk - s * C;
    int p = row / R, r = row - p * R;
    int src;
    if (s < S) {
      int b = p / N;
      src = b * N + idx[(size_t)p * k + r + s];
    } else {
      src = p;
    }
    return x[(size_t)src * C + c];
  }
};

constexpr int kWRows = 64;  // points per weight-net block

// One thread per (slot s, channel ch) of the 32-channel projection; slot s
// reads extraction index (s % 2) * hk + s / 2, the generator's (window, j)
// order, so the flat outputs line up with the block channel layout.
__global__ void wnet_kernel(const float* __restrict__ pcat,
                            const float* __restrict__ ppoint,
                            const int* __restrict__ idx, int N, int k,
                            int rows, float* __restrict__ wfea,
                            float* __restrict__ wxyz,
                            float* __restrict__ scratch) {
  const int col = threadIdx.x;  // < k * 32
  const int s = col / 32, ch = col % 32;
  const int hk = k / 2;
  const int j = (s % 2) * hk + s / 2;
  const int r0 = blockIdx.x * kWRows;
  const int r1 = min(r0 + kWRows, rows);
  float sum = 0.f, sq = 0.f;
  for (int r = r0; r < r1; ++r) {
    int b = r / N;
    int src = b * N + idx[(size_t)r * k + j];
    float v = pcat[(size_t)src * 32 + ch] + ppoint[(size_t)r * 32 + ch];
    if (ch < 16)
      wfea[(size_t)r * k * 16 + s * 16 + ch] = v;
    else
      wxyz[(size_t)r * k * 16 + s * 16 + ch - 16] = v;
    sum += v;
    sq += v * v;
  }
  float* o = scratch + (size_t)blockIdx.x * 2 * k * 32;
  o[col] = sum;
  o[k * 32 + col] = sq;
}

}  // namespace

extern "C" {

// x (B,N,C) per-point features; x_knn (B,N,Cf) the features the graph is
// built from. w_conv ((window+1)*C, 4Fin) = [wn; conv_a],
// w_merge ((k+1)*C, 2F) = [wen; a_merge]. pcat/ppoint may be null (plain
// stage). conv_scratch holds (rows_conv/64, 2, 4Fin) floats, w_scratch
// (ceil(B*N/64), 2, k*32).
int pdgn_edge_head(const float* x, const float* x_knn, int B, int N, int C,
                   int Cf, int k, const float* w_conv,
                   const float* pb_point, int four_fin, const float* w_merge,
                   const float* pb_merge, int two_f, const float* pcat,
                   const float* ppoint, int* idx, float* inte, float* partial,
                   float* stats, float* conv_scratch, float* wfea, float* wxyz,
                   float* wstats, float* w_scratch, cudaStream_t stream) {
  const int rows = B * N;
  const int hk = k / 2;
  const int window = hk + 1;

  cudaError_t err = pdgn::knn_select(x_knn, x_knn, B, N, N, Cf, k + 1, 1,
                                     /*direct=*/false, idx, nullptr, stream);
  if (err != cudaSuccess) return (int)err;

  // window conv: rows (b, n, wp), output written straight into inte
  const int rows_conv = rows * hk;
  GatherA a_conv{x, idx, N, C, k, hk, window};
  Epilogue e_conv{inte, pb_point, nullptr, N * hk, four_fin};
  gemm(a_conv, w_conv, rows_conv, (window + 1) * C, four_fin, e_conv,
       conv_scratch, stream);
  PDGN_CHECK_LAUNCH();
  column_reduce(conv_scratch, gemm_row_blocks(rows_conv), 2 * four_fin, stats,
                stream);
  PDGN_CHECK_LAUNCH();

  // merge partial: rows (b, n)
  GatherA a_merge{x, idx, N, C, k, 1, k};
  Epilogue e_merge{partial, pb_merge, nullptr, N, two_f};
  gemm(a_merge, w_merge, rows, (k + 1) * C, two_f, e_merge, nullptr, stream);
  PDGN_CHECK_LAUNCH();

  if (pcat != nullptr) {
    int nblk = (rows + kWRows - 1) / kWRows;
    wnet_kernel<<<nblk, k * 32, 0, stream>>>(pcat, ppoint, idx, N, k, rows,
                                             wfea, wxyz, w_scratch);
    PDGN_CHECK_LAUNCH();
    column_reduce(w_scratch, nblk, 2 * k * 32, wstats, stream);
    PDGN_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

}  // extern "C"
