// Native CPU spread/interp engine for tensorflow_nufft_tpu.
//
// Role: the host-side numerical core (backend='native'): float64 down to
// tolerances of 1e-14 on the host, and a fast CPU path. Counterpart of the reference's CPU spreader/interpolator
// (reference: tensorflow_nufft/cc/kernels/nufft_plan.cc:883-1806), but
// re-designed: spreading is parallelized by *output slab ownership*
// (each thread owns a contiguous band of leading-axis rows and
// accumulates only points whose footprint intersects it) — deterministic
// and atomics-free, unlike the reference's omp-critical/atomic
// add_wrapped_subgrid (nufft_plan.cc:1638-1734).
//
// Complex data is interleaved (re, im) pairs, matching both NumPy
// complex layout and the framework's planar layout.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC nufft_cpu.cc
//
// All exported symbols use the C ABI (ctypes-friendly).

#include <cmath>
#include <cstdint>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

namespace {

constexpr int kMaxRank = 3;

// "Exponential of semicircle" kernel phi(z) = exp(beta sqrt(1 - c z^2))
// on |z| < w/2 (reference: nufft_util.cc:64-69).
template <typename T>
inline T es_kernel(T z, T beta, T c, T half_width) {
  if (std::fabs(z) >= half_width) return T(0);
  T arg = T(1) - c * z * z;
  if (arg < T(0)) arg = T(0);
  return std::exp(beta * std::sqrt(arg));
}

template <typename T>
struct Geometry {
  int rank;
  int64_t dims[kMaxRank];    // fine grid dims
  int64_t strides[kMaxRank];
  int width;
  T beta, c, half_width;
};

template <typename T>
Geometry<T> make_geometry(int rank, const int64_t* dims, int width,
                          double beta) {
  Geometry<T> g;
  g.rank = rank;
  int64_t stride = 1;
  for (int d = rank - 1; d >= 0; --d) {
    g.dims[d] = dims[d];
    g.strides[d] = stride;
    stride *= dims[d];
  }
  g.width = width;
  g.beta = T(beta);
  g.c = T(4.0 / (width * width));
  g.half_width = T(width / 2.0);
  return g;
}

// Per-point kernel footprint along one axis: first covered integer
// i0 = ceil(s - w/2) and the width kernel values. Points are always
// double so single-precision data keeps full coordinate accuracy (the
// phase error of an f32 coordinate is k_max * 2^-24-scale otherwise).
template <typename T>
inline int64_t axis_kernel(const Geometry<T>& g, double s, T* vals) {
  int64_t i0 = (int64_t)std::ceil(s - (double)g.half_width);
  for (int j = 0; j < g.width; ++j) {
    vals[j] = es_kernel(T((double)(i0 + j) - s), g.beta, g.c,
                        g.half_width);
  }
  return i0;
}

inline int64_t wrap(int64_t i, int64_t n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------------
// Spread: strengths [batch, M] (interleaved complex) onto fine grid
// [batch, *dims]. Threads own contiguous slabs of the leading axis; each
// thread scans all points and accumulates only rows in its slab. The
// leading-axis kernel is evaluated per (thread, point) only on slab
// overlap, the inner axes in full.
template <typename T>
void spread_impl(const Geometry<T>& g, int64_t num_points, int64_t batch,
                 const double* points, const T* strengths, T* fine,
                 int num_threads) {
  const int64_t n0 = g.dims[0];
  const int64_t fine_size = g.strides[0] * g.dims[0];
  const int w = g.width;

#ifdef _OPENMP
  if (num_threads <= 0) num_threads = omp_get_max_threads();
#else
  num_threads = 1;
#endif
  const int slabs = (int)std::min<int64_t>(num_threads, n0);

#pragma omp parallel num_threads(slabs)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t r0 = n0 * t / slabs;
    const int64_t r1 = n0 * (t + 1) / slabs;
    T k0[16], k1[16], k2[16];
    T* kv[kMaxRank] = {k0, k1, k2};

    for (int64_t m = 0; m < num_points; ++m) {
      const double* p = points + m * g.rank;
      // Leading-axis footprint.
      const int64_t i0 =
          (int64_t)std::ceil(p[0] - (double)g.half_width);
      // Does [i0, i0+w) wrapped intersect [r0, r1)?
      bool hit = false;
      for (int j = 0; j < w && !hit; ++j) {
        const int64_t r = wrap(i0 + j, n0);
        hit = (r >= r0) & (r < r1);
      }
      if (!hit) continue;
      axis_kernel(g, p[0], kv[0]);
      int64_t base[kMaxRank];
      base[0] = i0;
      for (int d = 1; d < g.rank; ++d) {
        base[d] = axis_kernel(g, p[d], kv[d]);
      }

      for (int64_t b = 0; b < batch; ++b) {
        const T sr = strengths[(b * num_points + m) * 2];
        const T si = strengths[(b * num_points + m) * 2 + 1];
        T* out = fine + b * fine_size * 2;
        // Rank-specialized accumulation loops.
        if (g.rank == 1) {
          for (int j = 0; j < w; ++j) {
            const int64_t r = wrap(base[0] + j, n0);
            if (r < r0 || r >= r1) continue;
            const T kw = kv[0][j];
            out[r * 2] += kw * sr;
            out[r * 2 + 1] += kw * si;
          }
        } else if (g.rank == 2) {
          for (int j = 0; j < w; ++j) {
            const int64_t r = wrap(base[0] + j, n0);
            if (r < r0 || r >= r1) continue;
            const T ky = kv[0][j];
            T* row = out + r * g.strides[0] * 2;
            for (int jx = 0; jx < w; ++jx) {
              const int64_t cx = wrap(base[1] + jx, g.dims[1]);
              const T kw = ky * kv[1][jx];
              row[cx * 2] += kw * sr;
              row[cx * 2 + 1] += kw * si;
            }
          }
        } else {
          for (int j = 0; j < w; ++j) {
            const int64_t r = wrap(base[0] + j, n0);
            if (r < r0 || r >= r1) continue;
            const T kz = kv[0][j];
            T* plane = out + r * g.strides[0] * 2;
            for (int jy = 0; jy < w; ++jy) {
              const int64_t cy = wrap(base[1] + jy, g.dims[1]);
              const T kzy = kz * kv[1][jy];
              T* row = plane + cy * g.strides[1] * 2;
              for (int jx = 0; jx < w; ++jx) {
                const int64_t cx = wrap(base[2] + jx, g.dims[2]);
                const T kw = kzy * kv[2][jx];
                row[cx * 2] += kw * sr;
                row[cx * 2 + 1] += kw * si;
              }
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// Interp: gather fine grid [batch, *dims] at points -> values
// [batch, M]. Embarrassingly parallel over points.
template <typename T>
void interp_impl(const Geometry<T>& g, int64_t num_points, int64_t batch,
                 const double* points, const T* fine, T* values,
                 int num_threads) {
  const int64_t fine_size = g.strides[0] * g.dims[0];
  const int w = g.width;
#ifdef _OPENMP
  if (num_threads <= 0) num_threads = omp_get_max_threads();
#endif

#pragma omp parallel for num_threads(num_threads) schedule(static)
  for (int64_t m = 0; m < num_points; ++m) {
    const double* p = points + m * g.rank;
    T k0[16], k1[16], k2[16];
    T* kv[kMaxRank] = {k0, k1, k2};
    int64_t base[kMaxRank];
    int64_t idx[kMaxRank][16];
    for (int d = 0; d < g.rank; ++d) {
      base[d] = axis_kernel(g, p[d], kv[d]);
      for (int j = 0; j < w; ++j) {
        idx[d][j] = wrap(base[d] + j, g.dims[d]);
      }
    }
    for (int64_t b = 0; b < batch; ++b) {
      const T* in = fine + b * fine_size * 2;
      T acc_r = 0, acc_i = 0;
      if (g.rank == 1) {
        for (int j = 0; j < w; ++j) {
          const T kw = kv[0][j];
          acc_r += kw * in[idx[0][j] * 2];
          acc_i += kw * in[idx[0][j] * 2 + 1];
        }
      } else if (g.rank == 2) {
        for (int j = 0; j < w; ++j) {
          const T* row = in + idx[0][j] * g.strides[0] * 2;
          const T ky = kv[0][j];
          for (int jx = 0; jx < w; ++jx) {
            const T kw = ky * kv[1][jx];
            acc_r += kw * row[idx[1][jx] * 2];
            acc_i += kw * row[idx[1][jx] * 2 + 1];
          }
        }
      } else {
        for (int j = 0; j < w; ++j) {
          const T* plane = in + idx[0][j] * g.strides[0] * 2;
          const T kz = kv[0][j];
          for (int jy = 0; jy < w; ++jy) {
            const T* row = plane + idx[1][jy] * g.strides[1] * 2;
            const T kzy = kz * kv[1][jy];
            for (int jx = 0; jx < w; ++jx) {
              const T kw = kzy * kv[2][jx];
              acc_r += kw * row[idx[2][jx] * 2];
              acc_i += kw * row[idx[2][jx] * 2 + 1];
            }
          }
        }
      }
      values[(b * num_points + m) * 2] = acc_r;
      values[(b * num_points + m) * 2 + 1] = acc_i;
    }
  }
}

}  // namespace

extern "C" {

#define DEFINE_ENTRY(NAME, T, IMPL)                                     \
  void NAME(int rank, const int64_t* dims, int64_t num_points,          \
            int64_t batch, int width, double beta, int num_threads,     \
            const double* points, const T* a, T* b) {                   \
    Geometry<T> g = make_geometry<T>(rank, dims, width, beta);          \
    IMPL<T>(g, num_points, batch, points, a, b, num_threads);           \
  }

DEFINE_ENTRY(tfft_spread_f32, float, spread_impl)
DEFINE_ENTRY(tfft_spread_f64, double, spread_impl)
DEFINE_ENTRY(tfft_interp_f32, float, interp_impl)
DEFINE_ENTRY(tfft_interp_f64, double, interp_impl)

int tfft_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
