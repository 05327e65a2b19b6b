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
#include "tail_gate.cuh"
#include "tf32x3_gemm.cuh"

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
  const int K = (k / 2) * four_fin;
  if (k < 2 || k % 2 || ldg < K || ldg % 4 || ldw < two_f || ldw % 4)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_gate(inte, h, isc, ish, w2k, w2b, s2, t2,
                                      rows, k, four_fin, ldg, softmax, g,
                                      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)tc_gemm<false, kGFold>(RowsA{g, ldg}, wi, ldw, rows, two_f, ldg,
                                     ldg, AddStore{y, partial, bias, two_f,
                                                   two_f},
                                     stream);
}

}  // extern "C"
