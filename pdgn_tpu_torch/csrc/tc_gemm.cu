// The shared product core (tf32x3_gemm.cuh) on its own, for checks and
// yardsticks: out = (addend + A @ B) + bias, or out = A^T @ B reduced over
// the rows in 4096-row splits; folded, as the port runs it.
#include "tf32x3_gemm.cuh"

extern "C" {

// A (M, K) row-major, or (K, M) when trans; B (K, N); lda, ldb, and K
// (plain) or M (trans) multiples of 4, rows 16-byte aligned; addend (M, N)
// and bias (N) nullable (plain only); out (M, N); scratch tn_splits(K) * M
// * N floats (trans only).
int pdgn_tc_gemm(const float* A, int lda, const float* B, int ldb, int M,
                 int N, int K, int trans, const float* addend,
                 const float* bias, float* out, float* scratch,
                 cudaStream_t stream) {
  if (lda % 4 || ldb % 4 || ldb < N || (trans ? M % 4 || lda < M
                                              : K % 4 || lda < K))
    return (int)cudaErrorInvalidValue;
  const RowsA a{A, lda};
  if (trans) return (int)tc_gemm_tn(a, B, ldb, K, M, N, scratch, out, stream);
  return (int)tc_gemm<false, kGFold>(a, B, ldb, M, N, K, K,
                                     AddStore{out, addend, bias, N, N},
                                     stream);
}

}  // extern "C"
