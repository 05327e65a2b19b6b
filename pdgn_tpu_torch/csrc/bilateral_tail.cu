// Edge-conv stage tail for Hopper (sm_90a).
//
// Replaces the TPU kernels pdgn_tpu/ops/pallas/bilateral_tail.py::_gated_kernel
// (stages 2-4) and ::_plain_kernel (stage 1), launcher _pallas_tail:
//   gated: y = partial + (LeakyReLU(inte*isc + ish)
//                         * softmax_slots(LeakyReLU((h@w2k + w2b)*s2 + t2))) @ wi
//              + bias
//   plain: y = partial + LeakyReLU(inte*isc + ish) @ wi + bias
//
// What bounds it on the H100: operations. At stage 4 one cloud costs
// ~5.4 GFLOP of merge GEMM plus ~0.7 GFLOP of conv_all2 against ~40 MB of
// reads, far above the fp32 balance point.
//
// The simple design, two launches:
//   1. gate_kernel (or plain_gate_kernel, tail_gate.cuh) writes the gate g
//      (B, N, k/2 * 4Fin) in block channel layout. A thread owns one
//      (point, conv_all2 channel), runs the 64-wide conv_all2 dot for all k
//      slots from shared memory, applies the folded BN and LeakyReLU, the
//      softmax over the slots, and gates the BN+LeakyReLU of inte.
//   2. gemm_kernel computes y = (partial + g @ wi) + bias.
// Unlike the TPU kernel, g round-trips through device memory; removing that
// round trip is the first item of the tail's redesign.
#include "tail_gate.cuh"

extern "C" {

// partial (rows, 2F); inte (rows, k/2*4Fin); h (rows, k*64) or null for the
// plain stage; wi (k/2*4Fin, 2F); g scratch shaped like inte; y (rows, 2F).
int pdgn_bilateral_tail(const float* partial, const float* inte,
                        const float* h, const float* isc, const float* ish,
                        const float* w2k, const float* w2b, const float* s2,
                        const float* t2, const float* wi, const float* bias,
                        int rows, int k, int two_fin, int two_f, int softmax,
                        float* g, float* y, cudaStream_t stream) {
  const int K = (k / 2) * 2 * two_fin;
  cudaError_t err = launch_gate(inte, h, isc, ish, w2k, w2b, s2, t2, rows, k,
                                two_fin, softmax, g, stream);
  if (err != cudaSuccess) return (int)err;
  PlainA a{g, K};
  Epilogue epi{y, bias, partial, two_f};
  gemm(a, wi, rows, K, two_f, epi, stream);
  PDGN_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

}  // extern "C"
