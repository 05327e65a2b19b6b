// Exact k-nearest-neighbour selection, defined in knn.cu and shared by the
// sources that build a kNN graph (knn.cu's own entry points, edge_head.cu).
#pragma once

#include <cuda_runtime.h>

namespace pdgn {

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
