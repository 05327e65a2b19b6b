// Exact k-nearest-neighbour selection, defined in knn.cu and shared by the
// sources that build a kNN graph (knn.cu's own entry points, edge_head.cu,
// local_stats.cu), and the direct distance it ranks by at C <= 4, which
// local_stats.cu recomputes with the same bits.
#pragma once

#include <cuda_runtime.h>

namespace pdgn {

// The first C <= 4 channels of a row, the rest zero
__device__ __forceinline__ float4 load_row4(const float* p, int C) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = p[0];
  if (C > 1) v.y = p[1];
  if (C > 2) v.z = p[2];
  if (C > 3) v.w = p[3];
  return v;
}

// C <= 4: ((d0 + d1) + d2) + d3 with d_c = (q_c - y_c)^2, every step rounded
// on its own (never contracted into an FMA; zero-padded channels add an
// exact 0), so a caller that recomputes a distance gets knn_select's bits
__device__ __forceinline__ float direct_dist(float4 q, float4 y) {
  float e = __fsub_rn(q.x, y.x);
  float d = __fmul_rn(e, e);
  e = __fsub_rn(q.y, y.y);
  d = __fadd_rn(d, __fmul_rn(e, e));
  e = __fsub_rn(q.z, y.z);
  d = __fadd_rn(d, __fmul_rn(e, e));
  e = __fsub_rn(q.w, y.w);
  return __fadd_rn(d, __fmul_rn(e, e));
}

// The K smallest distances from every query row of q (B, M, C) to the rows
// of db (B, N, C), ascending, the lower index first on ties; slots
// drop..K-1 go to idx (B, M, K - drop). direct: fp32 direct differences
// (C <= 4); else the norm expansion (|q|^2 - 2<q,y>) + |y|^2. nbr non-null:
// the selected db rows are also copied into nbr (B, M, K - drop, C), whose
// rows (and db's) must be 16-byte aligned when C % 4 == 0. 1 <= K <= 128,
// K <= N, 0 <= drop < K.
cudaError_t knn_select(const float* q, const float* db, int B, int M, int N,
                       int C, int K, int drop, bool direct, int* idx,
                       float* nbr, cudaStream_t stream);

}  // namespace pdgn
