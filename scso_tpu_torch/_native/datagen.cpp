// Fast synthetic-data generation for the benchmark problem families.
//
// OpenMP C++ fill of the benchmark problem structures: the port's own
// copy of scso_tpu/_native/datagen.cpp, the same code, so that the same
// seed gives the same stream (scso_tpu_torch/models/synthetic.py,
// backend='native'). Host-side data work; the compute path is the
// port's CUDA kernels.
//
// Exposed via ctypes (scso_tpu_torch/_native/__init__.py): plain C ABI,
// caller allocates. RNG: splitmix64 -> xoshiro256** per row, Box-Muller
// normals — deterministic for a given seed, independent of thread count
// (each row derives its own stream).

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Rng {
  uint64_t s[4];

  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed;
    for (int i = 0; i < 4; ++i) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
      x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
      s[i] = x ^ (x >> 31);
    }
  }

  static uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  uint64_t next() {  // xoshiro256**
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  double uniform() {  // (0, 1)
    return ((next() >> 11) + 1) * 0x1.0p-53;
  }

  double normal() {  // Box-Muller (one value; wastes the pair — fine here)
    double u1 = uniform();
    double u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) *
           std::cos(6.283185307179586 * u2);
  }

  // Irwin-Hall(12) approximate normal: 12 cheap uniforms, no
  // transcendentals — plenty for synthetic benchmark data and ~5x
  // faster than Box-Muller.
  float normal_fast() {
    double acc = 0.0;
    for (int i = 0; i < 12; ++i) acc += uniform();
    return static_cast<float>(acc - 6.0);
  }

  // unbiased-enough bounded index without %: (next()*n) >> 64
  int64_t index(int64_t n) {
    return static_cast<int64_t>(
        (static_cast<unsigned __int128>(next()) *
         static_cast<unsigned __int128>(n)) >> 64);
  }
};

}  // namespace

extern "C" {

// Fill A (m*n, row-major, pre-zeroed by caller or here), y (m), x0 (n)
// with the sparse-design logistic regression problem: ~density*m*n
// standard-normal entries at uniform positions, labels Bernoulli at
// sigmoid(A @ x_true) with x_true having n_active normal entries.
// label01: 1 -> {0,1} labels, 0 -> {-1,+1}.
// Returns 0 on success.
int fill_sparse_logreg(float* A, float* y, float* x0, float* x_true,
                       int64_t m, int64_t n, double density,
                       int64_t n_active, int64_t seed, int label01) {
  std::memset(A, 0, sizeof(float) * static_cast<size_t>(m) * n);
  std::memset(x_true, 0, sizeof(float) * static_cast<size_t>(n));

  // x_true: n_active random coordinates (serial; n is small)
  {
    Rng r(static_cast<uint64_t>(seed) * 0x9E3779B9ULL + 1);
    for (int64_t k = 0; k < n_active; ++k) {
      int64_t idx = static_cast<int64_t>(r.next() % static_cast<uint64_t>(n));
      x_true[idx] = static_cast<float>(r.normal());
    }
    for (int64_t j = 0; j < n; ++j) {
      x0[j] = static_cast<float>(r.normal());
    }
  }

  const int64_t nnz_per_row =
      static_cast<int64_t>(density * static_cast<double>(n) + 0.5);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    Rng r(static_cast<uint64_t>(seed) ^
          (0xD1342543DE82EF95ULL * static_cast<uint64_t>(i + 1)));
    float* __restrict row = A + i * n;
    const float* __restrict xt = x_true;
    for (int64_t k = 0; k < nnz_per_row; ++k) {
      row[r.index(n)] = r.normal_fast();
    }
    // label from sigmoid(row . x_true)
    float z = 0.0f;
    for (int64_t j = 0; j < n; ++j) z += row[j] * xt[j];
    double p = 1.0 / (1.0 + std::exp(-z));
    bool one = r.uniform() < p;
    y[i] = one ? 1.0f : (label01 ? 0.0f : -1.0f);
  }
  return 0;
}

// Dense standard-normal matrix fill (row-parallel).
int fill_randn(float* A, int64_t m, int64_t n, int64_t seed) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    Rng r(static_cast<uint64_t>(seed) ^
          (0xA0761D6478BD642FULL * static_cast<uint64_t>(i + 1)));
    float* __restrict row = A + i * n;
    for (int64_t j = 0; j < n; ++j) {
      row[j] = r.normal_fast();
    }
  }
  return 0;
}

int omp_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
