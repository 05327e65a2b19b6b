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
//
// The operand type T (float or __nv_bfloat16) is a template parameter of
// the same tile loop: the bf16 instances (the bf16 head's P = x W_all, the
// bf16 tails' merge and every product of the bf16 backwards) stage
// 8-element granules through the same ring, take m16n8k16 bf16 products
// with fp32 accumulation (mma_bf16, two k16 steps a stage), keep the fold,
// the split partials and the epilogues. Two
// bf16 share a 32-bit word, so their rows are padded for 16-bit elements:
// A [m][k + 8] (20 words a row: g*20 mod 32 = 0, 20, 8, ..., 12, and t
// adds 0..3, 32 banks), B [k][n + 8] (68 words: rows 2t at 8t, g/2 adds
// 0..3).
//
// A transposed bf16 product (the bf16 backwards' weight gradients) stages
// its reduction-major A as [k][m + 8], the B tile's layout, and packs each
// A fragment register from two rows (adjacent k of one m) as the B
// fragments are packed: rows 2t at 8t banks, g/2 adds 0..3, the two g of a
// word broadcast. Its granules run along m, so M % 8 == 0; a gathering
// loader gives the source row of 8 adjacent columns.
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

// per operand type: elements a 16-byte granule, the padded tile rows
template <class T>
struct GemmOp {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kALd = kGK + kVec;  // A row-major tile [m][k]
  static constexpr int kATLd = kGM + 8;    // A reduction-major tile [k][m]
  static constexpr int kBLd = kGN + 8;     // B tile [k][n]
  static constexpr int kAStage = kGM * kALd;
  static constexpr int kBStage = kGK * kBLd;
  static constexpr int kSmemBytes =
      kGStages * (kAStage + kBStage) * (int)sizeof(T);
};
static_assert(GemmOp<float>::kAStage == kGAStage &&
                  GemmOp<float>::kBStage == kGBStage &&
                  GemmOp<float>::kSmemBytes == kGSmemBytes,
              "the fp32 instance's tiles");
static_assert(kGK * GemmOp<__nv_bfloat16>::kATLd <=
                  GemmOp<__nv_bfloat16>::kAStage,
              "bf16 reduction-major A tile too large");
// rows a split of a transposed product's reduction
constexpr int kSplitRows = 4096;

inline int tn_splits(long long R) {
  return (int)((R + kSplitRows - 1) / kSplitRows);
}

// A (rows, ld) row-major, of fp32 or bf16: at(r, c) is the address of
// element (r, c). A reduction-major loader also gives, in two steps, the
// source row of a granule (src_row: may read an index table) and its
// address (ptr).
template <class T>
struct RowsOf {
  const T* a;
  int ld;
  __device__ __forceinline__ const T* at(int r, int c) const {
    return a + (size_t)r * ld + c;
  }
  __device__ __forceinline__ int src_row(int r, int) const { return r; }
  __device__ __forceinline__ const T* ptr(int src, int c) const {
    return a + (size_t)src * ld + c;
  }
};
using RowsA = RowsOf<float>;
using RowsBf16 = RowsOf<__nv_bfloat16>;

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
// addend and bias nullable, fp32; out fp32 or bf16 (rounded once, at the
// store)
template <class TO>
struct AddStoreTo {
  TO* out;
  const float* addend;
  const float* bias;
  int ld, N;
  __device__ __forceinline__ void put(size_t o, int c, float acc) const {
    float v = addend ? addend[o] + acc : acc;
    if (bias) v += bias[c];
    store_as(out + o, v);
  }
  __device__ __forceinline__ void operator()(int, int r, int c, float v0,
                                             float v1) const {
    const size_t o = (size_t)r * ld + c;
    put(o, c, v0);
    if (c + 1 < N) put(o + 1, c + 1, v1);
  }
};

using AddStore = AddStoreTo<float>;

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

template <bool kTrans, int kFold, class ALoad, class Epi, class T>
__global__ void __launch_bounds__(kGThreads, kFold ? 1 : 2)
tc_gemm_kernel(ALoad A, const T* __restrict__ B, int ldb, int M, int N,
               int K, int k_split, Epi epi) {
  using Op = GemmOp<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  T* As = reinterpret_cast<T*>(smem);       // [stage][Op::kAStage]
  T* Bs = As + kGStages * Op::kAStage;      // [stage][kGK][Op::kBLd]
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
  constexpr int kAV = Op::kVec;
  constexpr int kAGran = kGK * kGM / kAV / kGThreads;
  int a_row[kAGran];
  auto a_rows = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kAGran; ++i) {
      const unsigned e = tid + i * kGThreads;
      const int gk = kb + kt * kGK + e / (kGM / kAV);
      const int gm = m0 + kAV * (e % (kGM / kAV));
      a_row[i] = gk < ke && gm < M ? A.src_row(gk, gm) : -1;
    }
  };

  auto load = [&](int stage, int kt) {
    const int k0 = kb + kt * kGK;
    T* as = As + stage * Op::kAStage;
    T* bs = Bs + stage * Op::kBStage;
    if constexpr (kTrans) {
#pragma unroll
      for (int i = 0; i < kAGran; ++i) {
        const unsigned e = tid + i * kGThreads;
        const int r = e / (kGM / kAV), q = e % (kGM / kAV);
        const bool ok = a_row[i] >= 0;
        cp_async16(as + r * Op::kATLd + kAV * q,
                   ok ? A.ptr(a_row[i], m0 + kAV * q) : B, ok ? 16 : 0);
      }
    } else {
      constexpr int V = Op::kVec;
#pragma unroll
      for (int i = 0; i < kGM * kGK / V / kGThreads; ++i) {
        const unsigned e = tid + i * kGThreads;
        const int r = e / (kGK / V), q = e % (kGK / V);
        const int gm = m0 + r, gk = k0 + V * q;
        const bool ok = gm < M && gk < ke;
        cp_async16(as + r * Op::kALd + V * q, ok ? A.at(gm, gk) : B,
                   ok ? 16 : 0);
      }
    }
    constexpr int V = Op::kVec;
#pragma unroll
    for (int i = 0; i < kGK * kGN / V / kGThreads; ++i) {
      const unsigned e = tid + i * kGThreads;
      const int r = e / (kGN / V), q = e % (kGN / V);
      const int gk = k0 + r, gc = n0 + V * q;
      const bool ok = gk < ke && gc < N;
      cp_async16(bs + r * Op::kBLd + V * q,
                 ok ? B + (size_t)gk * ldb + gc : B, ok ? 16 : 0);
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
    if constexpr (kBf16) {
      // a thread's A rows wm + mt*16 + g (+ 8), columns 2t (+ 8); its B
      // column wn + nt*8 + g, rows 2t (+ 1, + 8, + 9)
      const T* as = As + (kt % kGStages) * Op::kAStage +
                    (wm + g) * Op::kALd + 2 * t;
      // the reduction-major tile's column wm + g
      const T* At = As + (kt % kGStages) * Op::kAStage + wm + g;
      const T* bs =
          Bs + (kt % kGStages) * Op::kBStage + 2 * t * Op::kBLd + wn + g;
#pragma unroll
      for (int kk = 0; kk < kGK; kk += 16) {
        uint32_t bf[kGNT][2];
#pragma unroll
        for (int nt = 0; nt < kGNT; ++nt) {
          const T* b = bs + kk * Op::kBLd + nt * 8;
          bf[nt][0] = pack_bf16(b[0], b[Op::kBLd]);
          bf[nt][1] = pack_bf16(b[8 * Op::kBLd], b[9 * Op::kBLd]);
        }
#pragma unroll
        for (int mt = 0; mt < kGMT; ++mt) {
          uint32_t af[4];
          if constexpr (kTrans) {
            // A[m][k] = tile[k][m]: rows 2t (+ 1, + 8, + 9), columns g (+ 8)
            constexpr int L = Op::kATLd;
            const T* a = At + (kk + 2 * t) * L + mt * 16;
            af[0] = pack_bf16(a[0], a[L]);
            af[1] = pack_bf16(a[8], a[L + 8]);
            af[2] = pack_bf16(a[8 * L], a[9 * L]);
            af[3] = pack_bf16(a[8 * L + 8], a[9 * L + 8]);
          } else {
            const T* a = as + mt * 16 * Op::kALd + kk;
            af[0] = *reinterpret_cast<const uint32_t*>(a);
            af[1] = *reinterpret_cast<const uint32_t*>(a + 8 * Op::kALd);
            af[2] = *reinterpret_cast<const uint32_t*>(a + 8);
            af[3] = *reinterpret_cast<const uint32_t*>(a + 8 * Op::kALd + 8);
          }
#pragma unroll
          for (int nt = 0; nt < kGNT; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
        }
      }
    } else {
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
// in splits of k_split (a plain one ignores it). Row-major A needs K a
// multiple of a granule (4 fp32, 8 bf16), a reduction-major one M a
// multiple of a granule, and their rows and B's 16-byte aligned; B's ldb
// >= N rounded up to a granule.
template <bool kTrans, int kFold, class ALoad, class Epi, class T>
inline cudaError_t tc_gemm(ALoad A, const T* B, int ldb, int M, int N,
                           int K, int k_split, Epi epi, cudaStream_t stream) {
  auto kern = tc_gemm_kernel<kTrans, kFold, ALoad, Epi, T>;
  constexpr int smem = GemmOp<T>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (M < 1 || N < 1 || K < 1) return cudaSuccess;
  dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM,
            kTrans ? (K + k_split - 1) / k_split : 1);
  kern<<<grid, kGThreads, smem, stream>>>(A, B, ldb, M, N, K, k_split, epi);
  return cudaGetLastError();
}

// out (M, N) = sum over the R rows of A(r, :)^T B(r, :), folded, in splits
// of kSplitRows whose partials (scratch: tn_splits(R) * M * N floats) are
// added in a fixed order; A and B both fp32 or both bf16, out fp32
template <class ALoad, class T>
inline cudaError_t tc_gemm_tn(ALoad A, const T* B, int ldb, int R, int M,
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
