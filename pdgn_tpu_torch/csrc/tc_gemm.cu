// The port's products on their own, for checks and yardsticks: the shared
// product core (tf32x3_gemm.cuh), out = (addend + A @ B) + bias, or out =
// A^T @ B reduced over the rows in 4096-row splits, folded, as the port
// runs it; and hopper.cuh's bf16 wgmma product, out = A^T @ B with both
// operands MN-major, reduced over the rows in contiguous splits.
#include "hopper.cuh"
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

// out (M, N) fp32 = A^T B, A (K, M) and B (K, N) bf16 row-major, M and N
// multiples of 8, 16-byte aligned: product_bf16_kernel<true> over `splits`
// contiguous ranges of the K rows (1 <= splits <= ceil(K / 64)), their
// partials (scratch: splits * M * N floats) added in split order.
int pdgn_product_bf16(const __nv_bfloat16* A, const __nv_bfloat16* B, int K,
                      int M, int N, int splits, float* scratch, float* out,
                      cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || M % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err =
      bf16_tile_map_3d(&map_a, A, M, 1, K, M, M, 64, 1, kPK);
  if (err != cudaSuccess) return (int)err;
  err = bf16_tile_map_3d(&map_b, B, N, 1, K, N, N, 64, 1, kPK);
  if (err != cudaSuccess) return (int)err;
  const ProductArgs p{M, 1, (M + kPM - 1) / kPM, N, 1, (K + kPK - 1) / kPK,
                      0, 0, scratch, N};
  err = launch_product_bf16<true>(map_a, map_b, p, splits, stream);
  if (err != cudaSuccess) return (int)err;
  column_reduce(scratch, splits, M * N, out, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
