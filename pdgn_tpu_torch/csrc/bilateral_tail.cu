// Edge-conv stage tail for Hopper (sm_90a).
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/bilateral_tail.py::_gated_kernel
// (stages 2-4) and ::_plain_kernel (stage 1), launcher _pallas_tail:
//   gated: y = partial + (LeakyReLU(inte*isc + ish)
//                         * softmax_slots(LeakyReLU((h@w2k + w2b)*s2 + t2))) @ wi
//              + bias
//   plain: y = partial + LeakyReLU(inte*isc + ish) @ wi + bias
//
// What bounds it on the H100: operations. At stage 4, B=128 the merge is
// 687 GFLOP and conv_all2 86 GFLOP, both products that run on the tensor
// cores in 3xTF32 (495 / 3 TFLOP/s of fp32-accurate work), against ~6 GB
// of reads and writes.
//
// The design, two launches:
//   1. the gate g (rows, ldg) on the tensor cores (tail_gate.cuh's
//      gate_tc_kernel, which the backward recomputes g with), or the plain
//      stage's elementwise gate;
//   2. the merge y = (partial + g @ wi) + bias on the shared product core
//      (tf32x3_gemm.cuh), folded: depth k/2 * 4Fin (5,120 at stage 4).
// g makes one round trip through device memory (2.7 GB each way at stage
// 4, B=128); computing it in the product's A-tile load is the next step.
//
// The bf16 instances (pdgn_bilateral_tail_bf16; the TPU kernels with bf16
// inte, h and weights, bilateral_tail.py:74-132): the gate's bf16 instance
// (tail_gate.cuh: w, gi and g rounded to bf16 where the TPU kernels round
// them), then the merge on the core's bf16 instance (m16n8k16, fp32
// accumulation, folded as the fp32 one), partial and the bias added in fp32
// and y rounded to bf16 once, at its store.
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

// The bf16 instance: inte, h, w2k, wi, g and y bf16; ldg and ldw multiples
// of 8 (16-byte granules of 8), wi's pad rows and columns zero; the rest as
// pdgn_bilateral_tail.
int pdgn_bilateral_tail_bf16(const float* partial, const __nv_bfloat16* inte,
                             const __nv_bfloat16* h, const float* isc,
                             const float* ish, const __nv_bfloat16* w2k,
                             const float* w2b, const float* s2,
                             const float* t2, const __nv_bfloat16* wi,
                             int ldw, const float* bias, int rows, int k,
                             int four_fin, int two_f, int ldg, int softmax,
                             __nv_bfloat16* g, __nv_bfloat16* y,
                             cudaStream_t stream) {
  return bilateral_tail<__nv_bfloat16, RowsBf16>(
      partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, ldw, bias, rows, k,
      four_fin, two_f, ldg, softmax, g, y, stream);
}

}  // extern "C"
