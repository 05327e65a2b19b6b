// Fused Chamfer distance + approximate EMD (approxmatch) for Hopper (sm_90a):
// every pair of two cloud sets, forward only.
//
// Replaces the TPU kernel pdgn_tpu/ops/pallas/emd_cd.py::_kernel (launcher
// fused_cd_emd). For each pair (a_s, b_r) of n points each it computes
//   cd   = mean_i min_j d2_ij + mean_j min_i d2_ij   (direct differences)
//   cost = the approxmatch transport cost sum_ij match_ij * sqrt(d2_ij),
// round for round as pdgn_tpu/losses/emd.py::_rounds: nine rounds at
// level_r = -4^(7-r), K_r = exp(level_r * d2), and per round
//   pass 1: ratioL = remainL / (sum_j K remainR + 1e-9)
//   pass 2: sumr = (K^T ratioL) remainR,
//           ratioR = min(remainR / (sumr + 1e-9), 1) remainR,
//           remainR = max(0, remainR - sumr)
//   pass 3: remainL = max(0, remainL - ratioL (K ratioR)),
//           cost += sum_i ratioL_i sum_j K_ij d_ij ratioR_j.
//
// What bounds it on the H100: instruction issue. A pair of 2048-point
// clouds has 4.2M elements and every round visits each of them twice
// (pass 2 needs all of pass 1's ratioL, pass 3 all of pass 2's ratioR, and
// K, 16 MB a pair, fits no block's shared memory, so distances are
// recomputed each sweep), against 48 KB of coordinates in and 8 bytes out.
//
// The design: one block per pair, 8 warps, both clouds streamed through
// shared memory in tiles (any n; the four mass vectors live in device
// memory, one slice a pair, and only a block's own threads touch them).
//   * A row sweep: a warp owns 256 rows, 8 a lane (kLines: one shared load
//     of a column feeds 8 elements), and walks every column in order, so
//     its row sums are sequential and need no reduction. Exponent chaining,
//     inverted: level_{r-1} = 4 level_r, so K_{r-1} = K_r^4 and round r-1's
//     transport (pass 3) runs inside round r's row sweep at one exp plus two
//     squarings an element. A column sweep swaps the roles for pass 2. The
//     last round's transport is one more row sweep; the Chamfer minima come
//     with round 0's two sweeps.
//   * Fewer instructions an element: K = 2^(level log2(e) d2) by one
//     ex2.approx.f32, the level and log2(e) folded into one product with
//     d2. The PTX ISA gives ex2.approx.f32 a maximum relative error of
//     2^-22 (about 2.4e-7) over its full range, subnormal results included:
//     the non-flushing form is taken, since at level -16384 many K are
//     subnormal and count (the build uses neither --use_fast_math nor
//     -ftz=true). The transport's distance is one sqrt.approx (its flushing
//     form: only a d2 below 1.2e-38, a pair closer than 1.1e-19, reads 0).
//   * Culling exact zeros: the wrapper orders each cloud's points by Morton
//     code and passes a bounding box for every 32 consecutive points. From
//     round 1 on (levels -4096 .. -0.25) a warp skips a 32-column sub-tile
//     when level * (the squared gap between its rows' box and the
//     sub-tile's) is below -110: every K there is below e^-110, under half
//     the smallest fp32 subnormal, so it is exactly 0 in the row sums, the
//     column sums and the transport (K_{r-1} = K_r^4), and the result keeps
//     its bits. The test costs a few instructions a sub-tile, so it runs in
//     every round; it skips work in rounds 1-4 on the test phase's clouds.
//     Round 0 is not culled: the Chamfer minima need every distance.
// Every sum runs in a fixed order (per-thread sequential in column or row
// order, then a fixed shared-memory tree for the cost and the Chamfer sums):
// no float atomics, and two launches give bit-identical results.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kEmdWarps = 8;
constexpr int kEmdThreads = 32 * kEmdWarps;
constexpr int kLines = 8;                        // rows (columns) a lane
constexpr int kGroup = 32 * kLines;              // rows (columns) a warp
constexpr int kPassRows = kEmdWarps * kGroup;    // rows a block pass
constexpr int kTileCols = 1024;                  // columns a shared tile
constexpr int kSub = 32;                         // points a culling box
constexpr int kRounds = 9;
constexpr float kCullExp = 110.f;                // e^-110 << 2^-150
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one rounding sequence for every distance, so the row and column sweeps
// see the same d2 (and the same K) for an element
__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

__device__ __forceinline__ float level_of(int r) {
  return -ldexpf(1.f, 2 * (7 - r));  // -4^(7-r), exact
}

// squared gap between two boxes (lo xyz, hi xyz); 0 where they overlap
__device__ __forceinline__ float box_gap2(const float* a, const float* b) {
  const float gx = fmaxf(0.f, fmaxf(a[0] - b[3], b[0] - a[3]));
  const float gy = fmaxf(0.f, fmaxf(a[1] - b[4], b[1] - a[4]));
  const float gz = fmaxf(0.f, fmaxf(a[2] - b[5], b[2] - a[5]));
  return gx * gx + gy * gy + gz * gz;
}

struct Pair {
  const float* x1;    // (n, 3) left cloud, Morton order
  const float* x2;    // (m, 3)
  const float* box1;  // (ceil(n / 32), 6) lo xyz | hi xyz
  const float* box2;  // (ceil(m / 32), 6)
  int n, m;
  float* remainL;     // (n) device memory, this pair's own
  float* ratioL;
  float* remainR;     // (m)
  float* ratioR;
  unsigned long long seen, culled;  // culling tests, lane 0's counts
};

struct Tiles {
  float4* pts;    // (kTileCols) x, y, z, one mass
  float* mass;    // (kTileCols) a second mass
  float* box;     // (kTileCols / kSub, 6)
  float* gbox;    // (kEmdWarps, 6) each warp's group box
};

// the box of the warp's group g0 .. g0 + kGroup - 1 of a cloud of n points
// into box (the warp's slot of Tiles::gbox): the union of its 32-point
// boxes (kept in shared memory, not in registers, which the 8 lines use)
__device__ __forceinline__ void group_box(const float* boxes, int g0, int n,
                                          float* box) {
  const int lane = threadIdx.x & 31;
  const int tile = g0 / kSub + lane;
  const bool in = lane < kLines && tile * kSub < n;
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    float v = in ? boxes[(size_t)tile * 6 + e] : (e < 3 ? INFINITY : -INFINITY);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = e < 3 ? fminf(v, w) : fmaxf(v, w);
    }
    if (lane == 0) box[e] = v;
  }
  __syncwarp();
}

// stage points [p0, p0 + np) of a cloud with masses m1 (and m2) into t
__device__ __forceinline__ void stage(const Tiles& t, const float* x,
                                      const float* boxes, const float* m1,
                                      const float* m2, int p0, int np) {
  for (int e = threadIdx.x; e < np; e += kEmdThreads) {
    const float* p = x + (size_t)(p0 + e) * 3;
    t.pts[e] = make_float4(p[0], p[1], p[2], m1 ? m1[p0 + e] : 0.f);
    if (m2) t.mass[e] = m2[p0 + e];
  }
  const int nsub = (np + kSub - 1) / kSub;
  for (int e = threadIdx.x; e < nsub * 6; e += kEmdThreads)
    t.box[e] = boxes[(size_t)(p0 / kSub) * 6 + e];
}

// Row sweep. kBalance: pass 1 of the round at `level` (row sums with
// remainR, then ratioL). kTransport: pass 3 of the previous round (its K is
// K^4 when kBalance, else 2^(level log2e d2) itself: the final round), which
// updates remainL before pass 1 reads it and adds to `cost`. kChamfer: the
// row minima's sum into `cdrow`. cull: skip sub-tiles whose K are all 0.
template <bool kBalance, bool kTransport, bool kChamfer>
__device__ void row_sweep(Pair& s, const Tiles& t, float level, bool cull,
                          float& cost, float& cdrow) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = level * kLog2e;
  const float cull_d2 = kCullExp / -level;
  for (int i0 = 0; i0 < s.n; i0 += kPassRows) {
    const int g0 = i0 + warp * kGroup;
    const bool active = g0 < s.n;
    float ax[kLines], ay[kLines], az[kLines];
    float suml[kLines], tr[kLines], cc[kLines], mn[kLines];
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int i = min(g0 + q * 32 + lane, s.n - 1);
      ax[q] = s.x1[3 * i];
      ay[q] = s.x1[3 * i + 1];
      az[q] = s.x1[3 * i + 2];
      suml[q] = 0.f;
      tr[q] = 0.f;
      cc[q] = 0.f;
      mn[q] = INFINITY;
    }
    float* box = t.gbox + warp * 6;
    group_box(s.box1, active ? g0 : 0, s.n, box);
    for (int j0 = 0; j0 < s.m; j0 += kTileCols) {
      const int nc = min(kTileCols, s.m - j0);
      __syncthreads();  // the previous tile's readers are done
      stage(t, s.x2, s.box2, kBalance ? s.remainR : nullptr,
            kTransport ? s.ratioR : nullptr, j0, nc);
      __syncthreads();
      if (!active) continue;
      const int nsub = (nc + kSub - 1) / kSub;
      for (int sb = 0; sb < nsub; ++sb) {
        if (cull) {
          ++s.seen;
          if (box_gap2(box, t.box + sb * 6) > cull_d2) {
            ++s.culled;
            continue;
          }
        }
        const int je = min(sb * kSub + kSub, nc);
        for (int jj = sb * kSub; jj < je; ++jj) {
          const float4 c = t.pts[jj];
          const float qR = kTransport ? t.mass[jj] : 0.f;
#pragma unroll
          for (int q = 0; q < kLines; ++q) {
            const float d2 = sqdist(ax[q], ay[q], az[q], c.x, c.y, c.z);
            if (kChamfer) mn[q] = fminf(mn[q], d2);
            const float k = ex2_approx(__fmul_rn(scale, d2));
            if (kBalance) suml[q] = __fmaf_rn(k, c.w, suml[q]);
            if (kTransport) {
              float kp = k;
              if (kBalance) {
                const float k2 = __fmul_rn(k, k);
                kp = __fmul_rn(k2, k2);
              }
              const float w = __fmul_rn(kp, qR);
              tr[q] = __fadd_rn(tr[q], w);
              cc[q] = __fmaf_rn(w, sqrt_approx(d2), cc[q]);
            }
          }
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int i = g0 + q * 32 + lane;
      if (i >= s.n) continue;
      if (kTransport) {
        const float rl = s.ratioL[i];
        s.remainL[i] = fmaxf(0.f, s.remainL[i] - rl * tr[q]);
        cost = __fmaf_rn(rl, cc[q], cost);
      }
      if (kBalance) s.ratioL[i] = s.remainL[i] / (suml[q] + 1e-9f);
      if (kChamfer) cdrow += mn[q];
    }
  }
}

// Column sweep: pass 2 of the round at `level`; kChamfer adds the column
// minima's sum into `cdcol`.
template <bool kChamfer>
__device__ void col_sweep(Pair& s, const Tiles& t, float level, bool cull,
                          float& cdcol) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = level * kLog2e;
  const float cull_d2 = kCullExp / -level;
  for (int j0 = 0; j0 < s.m; j0 += kPassRows) {
    const int g0 = j0 + warp * kGroup;
    const bool active = g0 < s.m;
    float bx[kLines], by[kLines], bz[kLines], acc[kLines], mn[kLines];
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int j = min(g0 + q * 32 + lane, s.m - 1);
      bx[q] = s.x2[3 * j];
      by[q] = s.x2[3 * j + 1];
      bz[q] = s.x2[3 * j + 2];
      acc[q] = 0.f;
      mn[q] = INFINITY;
    }
    float* box = t.gbox + warp * 6;
    group_box(s.box2, active ? g0 : 0, s.m, box);
    for (int i0 = 0; i0 < s.n; i0 += kTileCols) {
      const int nr = min(kTileCols, s.n - i0);
      __syncthreads();
      stage(t, s.x1, s.box1, s.ratioL, nullptr, i0, nr);
      __syncthreads();
      if (!active) continue;
      const int nsub = (nr + kSub - 1) / kSub;
      for (int sb = 0; sb < nsub; ++sb) {
        if (cull) {
          ++s.seen;
          if (box_gap2(box, t.box + sb * 6) > cull_d2) {
            ++s.culled;
            continue;
          }
        }
        const int ie = min(sb * kSub + kSub, nr);
        for (int ii = sb * kSub; ii < ie; ++ii) {
          const float4 r = t.pts[ii];
#pragma unroll
          for (int q = 0; q < kLines; ++q) {
            const float d2 = sqdist(r.x, r.y, r.z, bx[q], by[q], bz[q]);
            if (kChamfer) mn[q] = fminf(mn[q], d2);
            const float k = ex2_approx(__fmul_rn(scale, d2));
            acc[q] = __fmaf_rn(k, r.w, acc[q]);
          }
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int j = g0 + q * 32 + lane;
      if (j >= s.m) continue;
      const float rr = s.remainR[j];
      const float sumr = acc[q] * rr;
      const float consumption = fminf(rr / (sumr + 1e-9f), 1.f);
      s.ratioR[j] = consumption * rr;
      s.remainR[j] = fmaxf(0.f, rr - sumr);
      if (kChamfer) cdcol += mn[q];
    }
  }
}

// sum of one value per thread in a fixed tree order
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kEmdThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kEmdThreads, 2)
emd_cd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ abox, const float* __restrict__ bbox,
              int R, int n, int m, int cull, float* masses,
              float* __restrict__ cd_out, float* __restrict__ cost_out,
              unsigned long long* counts) {
  __shared__ float4 s_pts[kTileCols];
  __shared__ float s_mass[kTileCols];
  __shared__ float s_box[kTileCols / kSub * 6];
  __shared__ float s_red[kEmdThreads];
  __shared__ float s_gbox[kEmdWarps * 6];
  const Tiles t{s_pts, s_mass, s_box, s_gbox};

  const int pair = blockIdx.x;
  const int sa = pair / R, rb = pair % R;
  const int na = (n + kSub - 1) / kSub, nb = (m + kSub - 1) / kSub;
  Pair s;
  s.x1 = a + (size_t)sa * n * 3;
  s.x2 = b + (size_t)rb * m * 3;
  s.box1 = abox + (size_t)sa * na * 6;
  s.box2 = bbox + (size_t)rb * nb * 6;
  s.n = n;
  s.m = m;
  s.remainL = masses + (size_t)pair * 2 * (n + m);
  s.ratioL = s.remainL + n;
  s.remainR = s.ratioL + n;
  s.ratioR = s.remainR + m;
  s.seen = s.culled = 0;
  for (int i = threadIdx.x; i < n; i += kEmdThreads) {
    s.remainL[i] = 1.f;  // multiL = 1: the wrapper takes n == m only
    s.ratioL[i] = 0.f;
  }
  for (int j = threadIdx.x; j < m; j += kEmdThreads) {
    s.remainR[j] = 1.f;
    s.ratioR[j] = 0.f;
  }
  // the first sweep's staging begins with a __syncthreads

  float cost = 0.f, cdrow = 0.f, cdcol = 0.f;
  row_sweep<true, false, true>(s, t, level_of(0), false, cost, cdrow);
  col_sweep<true>(s, t, level_of(0), false, cdcol);
  for (int r = 1; r < kRounds; ++r) {
    row_sweep<true, true, false>(s, t, level_of(r), cull, cost, cdrow);
    col_sweep<false>(s, t, level_of(r), cull, cdcol);
  }
  row_sweep<false, true, false>(s, t, level_of(kRounds - 1), cull, cost,
                                cdrow);
  __syncthreads();

  const float cost_sum = block_sum(cost, s_red);
  const float row_sum = block_sum(cdrow, s_red);
  const float col_sum = block_sum(cdcol, s_red);
  if (threadIdx.x == 0) {
    cost_out[pair] = cost_sum;
    cd_out[pair] = row_sum / (float)n + col_sum / (float)m;
  }
  if (counts != nullptr && (threadIdx.x & 31) == 0) {
    atomicAdd(counts, s.seen);
    atomicAdd(counts + 1, s.culled);
  }
}

}  // namespace

extern "C" {

// a (S, n, 3), b (R, m, 3) fp32 contiguous, each cloud in Morton order;
// abox (S, ceil(n/32), 6), bbox (R, ceil(m/32), 6) the boxes of every 32
// consecutive points (lo xyz, hi xyz) -> cd (S, R), cost (S, R): every pair
// (a_s, b_r), one block each. Needs n == m (the approxmatch masses are then
// 1). masses: S * R * 2 * (n + m) floats of scratch. cull: skip the exact
// zeros of rounds 1-8. counts: null, or two zeroed 64-bit counters that
// receive the culling tests made and passed (sub-tiles skipped).
int pdgn_emd_cd(const float* a, const float* b, const float* abox,
                const float* bbox, int S, int R, int n, int m, int cull,
                float* masses, float* cd, float* cost,
                unsigned long long* counts, cudaStream_t stream) {
  if (n != m || n < 1 || S < 1 || R < 1) return (int)cudaErrorInvalidValue;
  emd_cd_kernel<<<S * R, kEmdThreads, 0, stream>>>(
      a, b, abox, bbox, R, n, m, cull, masses, cd, cost, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
