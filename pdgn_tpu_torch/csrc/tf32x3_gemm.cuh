// The port's one fp32-accurate tensor-core product core (3xTF32 through
// mma_tf32x3.cuh), shared by every fp32 product that runs on the tensor
// cores: the head's P = x W_all (edge_head.cu), the tails' merge
// (bilateral_tail.cu), the head backward's products (edge_head_bwd.cu) and
// the tail backward's (bilateral_tail_bwd.cu).
//
//   tc_gemm<false>: out (M, N) = A (M, K) @ B (K, N)
//   tc_gemm<true>:  out (M, N) = A^T @ B, A given reduction-major as (K, M)
//                   rows: a weight gradient, whose reduction runs over rows
//
// 128 x 128 output tiles, 8 warps of 64 x 32, 32-deep stages through a
// 3-stage cp.async ring, shared rows padded so that fragment reads hit 32
// banks (A row-major: [m][k + 4]; A reduction-major: [k][m + 8]; B:
// [k][n + 8]). The A loader gives the device address of a 16-byte granule
// (a reduction-major one its source row first, read a stage ahead), so its
// rows may be gathered; granules past the edges are zero-filled. B is
// row-major with ldb >= N rounded up to 4. The epilogue functor takes two
// adjacent columns of one row (col even, col < N).
//
// A transposed product's reduction is cut into splits of k_split
// (gridDim.z = splits) whose partials column_reduce adds in a fixed order
// (tc_gemm_tn), so weight gradients are deterministic with no float
// atomics.
//
// The fold (kFold > 0): the tensor cores truncate their additions, so a
// long chain of mma accumulations drifts (~1e-5 over 1,248 rows in slot
// stats, ~5e-5 at the tail merge's depth 5,120 in the numpy emulation of
// tests/test_torch_tf32x3.py). The accumulators then restart every kFold
// stages (kGFold: 128 of depth) and are added into fp32 totals by rounded
// adds. Totals and accumulators take 128 registers a thread, so a folding
// instance runs one block an SM; the head's product (depth <= 128) does
// not fold and keeps two.
#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kGM = 128, kGN = 128, kGK = 32;
constexpr int kGStages = 3;
constexpr int kGMT = 4, kGNT = 4;  // a warp's (16 x 8) tiles: 64 x 32
constexpr int kGWarpsN = kGN / (8 * kGNT);
constexpr int kGThreads = 32 * (kGM / (16 * kGMT)) * kGWarpsN;
constexpr int kGALd = kGK + 4;   // A row-major tile [m][k]
constexpr int kGATLd = kGM + 8;  // A reduction-major tile [k][m]
constexpr int kGBLd = kGN + 8;   // B tile [k][n]
constexpr int kGAStage = kGM * kGALd;
constexpr int kGBStage = kGK * kGBLd;
constexpr int kGSmemBytes = kGStages * (kGAStage + kGBStage) * 4;  // 107,520
constexpr int kGFold = 4;        // stages between folds: 128 of depth
static_assert(kGK * kGATLd <= kGAStage, "reduction-major A tile too large");
// rows a split of a transposed product's reduction
constexpr int kSplitRows = 4096;

inline int tn_splits(long long R) {
  return (int)((R + kSplitRows - 1) / kSplitRows);
}

// A (rows, ld) row-major: at(r, c) is the address of element (r, c). A
// reduction-major loader also gives, in two steps, the source row of a
// granule (src_row: may read an index table) and its address (ptr).
struct RowsA {
  const float* a;
  int ld;
  __device__ __forceinline__ const float* at(int r, int c) const {
    return a + (size_t)r * ld + c;
  }
  __device__ __forceinline__ int src_row(int r, int) const { return r; }
  __device__ __forceinline__ const float* ptr(int src, int c) const {
    return a + (size_t)src * ld + c;
  }
};

// out[r, c] = acc as float2 pairs: out (rows, ld), ld and N even
struct StorePairs {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int, int r, int c, float v0,
                                             float v1) const {
    *reinterpret_cast<float2*>(out + (size_t)r * ld + c) =
        make_float2(v0, v1);
  }
};

// out[r, c] = (addend[r, c] + acc) + bias[c], out and addend (rows, ld);
// addend and bias nullable
struct AddStore {
  float* out;
  const float* addend;
  const float* bias;
  int ld, N;
  __device__ __forceinline__ void put(size_t o, int c, float acc) const {
    float v = addend ? addend[o] + acc : acc;
    if (bias) v += bias[c];
    out[o] = v;
  }
  __device__ __forceinline__ void operator()(int, int r, int c, float v0,
                                             float v1) const {
    const size_t o = (size_t)r * ld + c;
    put(o, c, v0);
    if (c + 1 < N) put(o + 1, c + 1, v1);
  }
};

// split z's partial of a transposed product: scratch (splits, M, N)
struct StorePartial {
  float* scratch;
  int M, N;
  __device__ __forceinline__ void operator()(int z, int r, int c, float v0,
                                             float v1) const {
    float* o = scratch + ((size_t)z * M + r) * N + c;
    o[0] = v0;
    if (c + 1 < N) o[1] = v1;
  }
};

template <bool kTrans, int kFold, class ALoad, class Epi>
__global__ void __launch_bounds__(kGThreads, kFold ? 1 : 2)
tc_gemm_kernel(ALoad A, const float* __restrict__ B, int ldb, int M, int N,
               int K, int k_split, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                       // [stage][kGAStage]
  float* Bs = smem + kGStages * kGAStage;  // [stage][kGK][kGBLd]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int wm = (warp / kGWarpsN) * 16 * kGMT;
  const int wn = (warp % kGWarpsN) * 8 * kGNT;
  // only a transposed product splits its reduction
  const int kb = kTrans ? blockIdx.z * k_split : 0;
  const int ke = !kTrans || K - kb < k_split ? K : kb + k_split;
  const int ktiles = (ke - kb + kGK - 1) / kGK;

  // reduction-major A: the source rows of the next stage's granules (-1:
  // zero-filled), read a stage ahead, so that a gathering loader's index
  // reads overlap the products
  constexpr int kAGran = kGK * kGM / 4 / kGThreads;
  int a_row[kAGran];
  auto a_rows = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kAGran; ++i) {
      const unsigned e = tid + i * kGThreads;
      const int gk = kb + kt * kGK + e / (kGM / 4);
      const int gm = m0 + 4 * (e % (kGM / 4));
      a_row[i] = gk < ke && gm < M ? A.src_row(gk, gm) : -1;
    }
  };

  auto load = [&](int stage, int kt) {
    const int k0 = kb + kt * kGK;
    float* as = As + stage * kGAStage;
    float* bs = Bs + stage * kGBStage;
    if constexpr (kTrans) {
#pragma unroll
      for (int i = 0; i < kAGran; ++i) {
        const unsigned e = tid + i * kGThreads;
        const int r = e / (kGM / 4), q = e % (kGM / 4);
        const bool ok = a_row[i] >= 0;
        cp_async16(as + r * kGATLd + 4 * q,
                   ok ? A.ptr(a_row[i], m0 + 4 * q) : B, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kGM * kGK / 4 / kGThreads; ++i) {
        const unsigned e = tid + i * kGThreads;
        const int r = e / (kGK / 4), q = e % (kGK / 4);
        const int gm = m0 + r, gk = k0 + 4 * q;
        const bool ok = gm < M && gk < ke;
        cp_async16(as + r * kGALd + 4 * q, ok ? A.at(gm, gk) : B,
                   ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < kGK * kGN / 4 / kGThreads; ++i) {
      const unsigned e = tid + i * kGThreads;
      const int r = e / (kGN / 4), q = e % (kGN / 4);
      const int gk = k0 + r, gc = n0 + 4 * q;
      const bool ok = gk < ke && gc < N;
      cp_async16(bs + r * kGBLd + 4 * q, ok ? B + (size_t)gk * ldb + gc : B,
                 ok ? 16 : 0);
    }
  };

  float acc[kGMT][kGNT][4], tot[kGMT][kGNT][4];
#pragma unroll
  for (int i = 0; i < kGMT; ++i)
#pragma unroll
    for (int j = 0; j < kGNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = tot[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < ktiles) {
      if constexpr (kTrans) a_rows(s);
      load(s, s);
    }
    cp_async_commit();
  }
  if constexpr (kTrans) {
    if (kGStages - 1 < ktiles) a_rows(kGStages - 1);
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    const int nk = kt + kGStages - 1;  // refills the stage read at kt - 1
    if (nk < ktiles) {
      load(nk % kGStages, nk);
      if constexpr (kTrans) {
        if (nk + 1 < ktiles) a_rows(nk + 1);
      }
    }
    cp_async_commit();
    const float* as = As + (kt % kGStages) * kGAStage +
                      (kTrans ? t * kGATLd + wm + g : (wm + g) * kGALd + t);
    const float* bs = Bs + (kt % kGStages) * kGBStage + t * kGBLd + wn + g;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 8) {
      uint32_t bhi[kGNT][2], blo[kGNT][2];
#pragma unroll
      for (int nt = 0; nt < kGNT; ++nt) {
        split_tf32(bs[kk * kGBLd + nt * 8], bhi[nt][0], blo[nt][0]);
        split_tf32(bs[(kk + 4) * kGBLd + nt * 8], bhi[nt][1], blo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kGMT; ++mt) {
        uint32_t ahi[4], alo[4];
        if constexpr (kTrans) {
          const float* a = as + kk * kGATLd + mt * 16;
          split_tf32(a[0], ahi[0], alo[0]);
          split_tf32(a[8], ahi[1], alo[1]);
          split_tf32(a[4 * kGATLd], ahi[2], alo[2]);
          split_tf32(a[4 * kGATLd + 8], ahi[3], alo[3]);
        } else {
          const float* a = as + mt * 16 * kGALd + kk;
          split_tf32(a[0], ahi[0], alo[0]);
          split_tf32(a[8 * kGALd], ahi[1], alo[1]);
          split_tf32(a[4], ahi[2], alo[2]);
          split_tf32(a[8 * kGALd + 4], ahi[3], alo[3]);
        }
#pragma unroll
        for (int nt = 0; nt < kGNT; ++nt)
          mma_tf32x3(acc[mt][nt], ahi, alo, bhi[nt], blo[nt]);
      }
    }
    if constexpr (kFold > 0) {
      if ((kt + 1) % kFold == 0) {
#pragma unroll
        for (int i = 0; i < kGMT; ++i)
#pragma unroll
          for (int j = 0; j < kGNT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              tot[i][j][q] += acc[i][j][q];
              acc[i][j][q] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kGMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kGNT; ++nt) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = kFold > 0 ? tot[mt][nt][q] + acc[mt][nt][q] : acc[mt][nt][q];
      const int r = m0 + wm + mt * 16 + g;
      const int c = n0 + wn + nt * 8 + 2 * t;
      if (c >= N) continue;
      if (r < M) epi((int)blockIdx.z, r, c, v[0], v[1]);
      if (r + 8 < M) epi((int)blockIdx.z, r + 8, c, v[2], v[3]);
    }
}

// out = A B (kTrans false) or A^T B (true) over depth K, a transposed one
// in splits of k_split (a plain one ignores it). Row-major A needs K % 4 ==
// 0, a reduction-major one M % 4 == 0, and their rows and B's 16-byte
// aligned.
template <bool kTrans, int kFold, class ALoad, class Epi>
inline cudaError_t tc_gemm(ALoad A, const float* B, int ldb, int M, int N,
                           int K, int k_split, Epi epi, cudaStream_t stream) {
  auto kern = tc_gemm_kernel<kTrans, kFold, ALoad, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBytes);
  if (err != cudaSuccess) return err;
  if (M < 1 || N < 1 || K < 1) return cudaSuccess;
  dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM,
            kTrans ? (K + k_split - 1) / k_split : 1);
  kern<<<grid, kGThreads, kGSmemBytes, stream>>>(A, B, ldb, M, N, K, k_split,
                                                 epi);
  return cudaGetLastError();
}

// out (M, N) = sum over the R rows of A(r, :)^T B(r, :), folded, in splits
// of kSplitRows whose partials (scratch: tn_splits(R) * M * N floats) are
// added in a fixed order
template <class ALoad>
inline cudaError_t tc_gemm_tn(ALoad A, const float* B, int ldb, int R, int M,
                              int N, float* scratch, float* out,
                              cudaStream_t stream) {
  cudaError_t err = tc_gemm<true, kGFold>(A, B, ldb, M, N, R, kSplitRows,
                                          StorePartial{scratch, M, N},
                                          stream);
  if (err != cudaSuccess) return err;
  column_reduce(scratch, tn_splits(R), M * N, out, stream);
  return cudaGetLastError();
}

}  // namespace
