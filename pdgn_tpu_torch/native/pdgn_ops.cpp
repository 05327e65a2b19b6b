// The native CPU oracles of the point ops (port of
// pdgn_tpu/native/pdgn_ops.cc:20-212, without its XLA FFI bindings).
//
// Scalar C++ on the host that follows the reference's CUDA kernels step by
// step: knnquery (insertion-sort kNN, first-seen index on ties), nndistance
// (bidirectional nearest squared distances), approxmatch (the 9-round
// balancing with its integer-division multipliers, accumulated in double)
// and furthest point sampling from index 0. They hold the port's torch code
// and CUDA kernels from outside: nothing on a main path calls them.
//
// A plain C interface over row-major buffers, loaded with ctypes
// (pdgn_tpu_torch/native/__init__.py): float32 inputs, int32/float32
// outputs, shapes as int64. Every entry returns 0, or 1 when it could not
// allocate its scratch. Built with g++ -shared -fPIC -O3 -std=c++17 and
// nothing more (no -march, no -ffast-math), the JAX package's flags, so that
// its results equal that build's bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <new>
#include <vector>

namespace {

inline float Sq(float v) { return v * v; }

inline float Dist2(const float* a, const float* b) {
  return Sq(a[0] - b[0]) + Sq(a[1] - b[1]) + Sq(a[2] - b[2]);
}

}  // namespace

extern "C" {

// xyz (b,n,3), new_xyz (b,m,3) -> idx (b,m,k) int32, dist2 (b,m,k) float32
int pdgn_knnquery(const float* xp, const float* qp, int64_t b, int64_t n,
                  int64_t m, int64_t k, int32_t* ip, float* dp) {
  try {
    std::vector<double> best(k);
    std::vector<int32_t> besti(k);
    for (int64_t bi = 0; bi < b; ++bi) {
      const float* xb = xp + bi * n * 3;
      for (int64_t mi = 0; mi < m; ++mi) {
        const float* q = qp + (bi * m + mi) * 3;
        std::fill(best.begin(), best.end(), 1e40);
        std::fill(besti.begin(), besti.end(), 0);
        for (int64_t p = 0; p < n; ++p) {
          const float d2 = Dist2(q, xb + p * 3);
          // insertion sort with strict '<': first-seen index wins on ties,
          // matching knnquery_cuda_kernel.cu:32-42
          for (int64_t j = 0; j < k; ++j) {
            if (d2 < best[j]) {
              for (int64_t t = k - 1; t > j; --t) {
                best[t] = best[t - 1];
                besti[t] = besti[t - 1];
              }
              best[j] = d2;
              besti[j] = static_cast<int32_t>(p);
              break;
            }
          }
        }
        for (int64_t j = 0; j < k; ++j) {
          ip[(bi * m + mi) * k + j] = besti[j];
          dp[(bi * m + mi) * k + j] = static_cast<float>(best[j]);
        }
      }
    }
  } catch (const std::bad_alloc&) {
    return 1;
  }
  return 0;
}

// x (b,n,3), y (b,m,3) -> dl (b,n) (min over y), dr (b,m) (min over x)
int pdgn_nndistance(const float* xp, const float* yp, int64_t b, int64_t n,
                    int64_t m, float* dlp, float* drp) {
  for (int64_t bi = 0; bi < b; ++bi) {
    const float* xb = xp + bi * n * 3;
    const float* yb = yp + bi * m * 3;
    for (int64_t i = 0; i < n; ++i) {
      float best = Dist2(xb + i * 3, yb);
      for (int64_t j = 1; j < m; ++j)
        best = std::min(best, Dist2(xb + i * 3, yb + j * 3));
      dlp[bi * n + i] = best;
    }
    for (int64_t j = 0; j < m; ++j) {
      float best = Dist2(yb + j * 3, xb);
      for (int64_t i = 1; i < n; ++i)
        best = std::min(best, Dist2(yb + j * 3, xb + i * 3));
      drp[bi * m + j] = best;
    }
  }
  return 0;
}

// x1 (b,n,3), x2 (b,m,3) -> cost (b,)
int pdgn_approxmatch(const float* p1, const float* p2, int64_t b, int64_t n,
                     int64_t m, float* cp) {
  // integer-division multipliers, matching approxmatch.cu:6-12
  const float multiL = (n >= m) ? 1.0f : static_cast<float>(m / n);
  const float multiR = (n >= m) ? static_cast<float>(n / m) : 1.0f;

  try {
    std::vector<double> remainL(n), remainR(m), ratioL(n), ratioR(m);
    std::vector<double> D(n * m), K(n * m);
    std::vector<double> match(n * m);

    for (int64_t bi = 0; bi < b; ++bi) {
      const float* a = p1 + bi * n * 3;
      const float* c = p2 + bi * m * 3;
      for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < m; ++j)
          D[i * m + j] = Dist2(a + i * 3, c + j * 3);
      std::fill(match.begin(), match.end(), 0.0);
      std::fill(remainL.begin(), remainL.end(), multiL);
      std::fill(remainR.begin(), remainR.end(), multiR);

      for (int j = 7; j > -2; --j) {
        const double level = -std::pow(4.0, j);
        for (int64_t t = 0; t < n * m; ++t) K[t] = std::exp(level * D[t]);
        // pass 1
        for (int64_t i = 0; i < n; ++i) {
          double suml = 1e-9;
          for (int64_t l = 0; l < m; ++l) suml += K[i * m + l] * remainR[l];
          ratioL[i] = remainL[i] / suml;
        }
        // pass 2
        for (int64_t l = 0; l < m; ++l) {
          double sumr = 0.0;
          for (int64_t i = 0; i < n; ++i) sumr += K[i * m + l] * ratioL[i];
          sumr *= remainR[l];
          const double consumption =
              std::min(remainR[l] / (sumr + 1e-9), 1.0);
          ratioR[l] = consumption * remainR[l];
          remainR[l] = std::max(0.0, remainR[l] - sumr);
        }
        // pass 3
        for (int64_t i = 0; i < n; ++i) {
          double suml = 0.0;
          for (int64_t l = 0; l < m; ++l) {
            const double w = K[i * m + l] * ratioL[i] * ratioR[l];
            match[i * m + l] += w;
            suml += w;
          }
          remainL[i] = std::max(0.0, remainL[i] - suml);
        }
      }
      double total = 0.0;
      for (int64_t i = 0; i < n; ++i)
        for (int64_t l = 0; l < m; ++l)
          total += match[i * m + l] * std::sqrt(D[i * m + l]);
      cp[bi] = static_cast<float>(total);
    }
  } catch (const std::bad_alloc&) {
    return 1;
  }
  return 0;
}

// xyz (b,n,3) -> idx (b,m) int32
int pdgn_fps(const float* xp, int64_t b, int64_t n, int64_t m, int32_t* ip) {
  try {
    std::vector<float> mind2(n);
    for (int64_t bi = 0; bi < b; ++bi) {
      const float* xb = xp + bi * n * 3;
      std::fill(mind2.begin(), mind2.end(), 1e10f);
      int64_t last = 0;
      ip[bi * m + 0] = 0;
      for (int64_t s = 1; s < m; ++s) {
        float bestv = -1.0f;
        int64_t besti = 0;
        for (int64_t p = 0; p < n; ++p) {
          mind2[p] = std::min(mind2[p], Dist2(xb + p * 3, xb + last * 3));
          if (mind2[p] > bestv) {
            bestv = mind2[p];
            besti = p;
          }
        }
        last = besti;
        ip[bi * m + s] = static_cast<int32_t>(besti);
      }
    }
  } catch (const std::bad_alloc&) {
    return 1;
  }
  return 0;
}

}  // extern "C"
