// Native CPU gate-apply engine.
//
// Purpose in this framework (the TPU path is JAX/XLA — see
// rustqip_tpu/engine/):
//   1. An independent correctness oracle for the device engine, exercised
//      from tests via ctypes.
//   2. The measured CPU baseline for bench.py's vs_baseline ratio: this
//      implements the same algorithm class as the reference's Rust engine
//      (row-parallel strided apply over 2^n amplitudes with lazy
//      nonzero-column enumeration, qip-iterators/src/matrix_ops.rs), with
//      OpenMP standing in for rayon. No Rust toolchain ships in this image,
//      so the reference's own benches can't run; this is the same-machine
//      stand-in.
//
// Conventions match the framework: big-endian qubits (qubit i is bit n-1-i
// of the state index); an op's j-th qubit is bit k-1-j of its sub-index.
// Complex amplitudes are interleaved (re, im) float32 or float64 pairs.

#include <cstdint>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t full_to_sub(int n, const int32_t* idx, int k, uint64_t full) {
  uint64_t sub = 0;
  for (int j = 0; j < k; ++j) {
    uint64_t bit = (full >> (n - 1 - idx[j])) & 1ull;
    sub |= bit << (k - 1 - j);
  }
  return sub;
}

inline uint64_t sub_to_full(int n, const int32_t* idx, int k, uint64_t sub,
                            uint64_t base) {
  uint64_t full = base;
  for (int j = 0; j < k; ++j) {
    uint64_t bit = (sub >> (k - 1 - j)) & 1ull;
    uint64_t pos = n - 1 - idx[j];
    full = (full & ~(1ull << pos)) | (bit << pos);
  }
  return full;
}

// Dense k-qubit matrix applied to all 2^n amplitudes, row-parallel.
template <typename T>
void apply_dense(int n, const int32_t* idx, int k, const T* mat, const T* in,
                 T* out) {
  const uint64_t dim = 1ull << n;
  const uint64_t sub_dim = 1ull << k;
#pragma omp parallel for schedule(static)
  for (int64_t row = 0; row < (int64_t)dim; ++row) {
    uint64_t matrow = full_to_sub(n, idx, k, (uint64_t)row);
    T acc_re = 0, acc_im = 0;
    const T* mrow = mat + 2 * matrow * sub_dim;
    for (uint64_t col = 0; col < sub_dim; ++col) {
      T mre = mrow[2 * col], mim = mrow[2 * col + 1];
      if (mre == 0 && mim == 0) continue;
      uint64_t src = sub_to_full(n, idx, k, col, (uint64_t)row);
      T vre = in[2 * src], vim = in[2 * src + 1];
      acc_re += mre * vre - mim * vim;
      acc_im += mre * vim + mim * vre;
    }
    out[2 * row] = acc_re;
    out[2 * row + 1] = acc_im;
  }
}

// Controlled dense apply: identity rows outside the all-controls-one slab.
template <typename T>
void apply_control_dense(int n, const int32_t* cidx, int nc,
                         const int32_t* tidx, int k, const T* mat, const T* in,
                         T* out) {
  const uint64_t dim = 1ull << n;
  const uint64_t sub_dim = 1ull << k;
  uint64_t cmask = 0;
  for (int j = 0; j < nc; ++j) cmask |= 1ull << (n - 1 - cidx[j]);
#pragma omp parallel for schedule(static)
  for (int64_t row = 0; row < (int64_t)dim; ++row) {
    if (((uint64_t)row & cmask) != cmask) {
      out[2 * row] = in[2 * row];
      out[2 * row + 1] = in[2 * row + 1];
      continue;
    }
    uint64_t matrow = full_to_sub(n, tidx, k, (uint64_t)row);
    T acc_re = 0, acc_im = 0;
    const T* mrow = mat + 2 * matrow * sub_dim;
    for (uint64_t col = 0; col < sub_dim; ++col) {
      T mre = mrow[2 * col], mim = mrow[2 * col + 1];
      if (mre == 0 && mim == 0) continue;
      uint64_t src = sub_to_full(n, tidx, k, col, (uint64_t)row);
      T vre = in[2 * src], vim = in[2 * src + 1];
      acc_re += mre * vre - mim * vim;
      acc_im += mre * vim + mim * vre;
    }
    out[2 * row] = acc_re;
    out[2 * row + 1] = acc_im;
  }
}

// Register swap: pure index permutation.
template <typename T>
void apply_swap(int n, const int32_t* aidx, const int32_t* bidx, int half,
                const T* in, T* out) {
  const uint64_t dim = 1ull << n;
#pragma omp parallel for schedule(static)
  for (int64_t row = 0; row < (int64_t)dim; ++row) {
    uint64_t src = (uint64_t)row;
    for (int j = 0; j < half; ++j) {
      uint64_t pa = n - 1 - aidx[j], pb = n - 1 - bidx[j];
      uint64_t ba = (src >> pa) & 1ull, bb = (src >> pb) & 1ull;
      if (ba != bb) src ^= (1ull << pa) | (1ull << pb);
    }
    out[2 * row] = in[2 * src];
    out[2 * row + 1] = in[2 * src + 1];
  }
}

template <typename T>
double prob_magnitude(int n, const T* state) {
  const uint64_t dim = 1ull << n;
  double total = 0;
#pragma omp parallel for reduction(+ : total) schedule(static)
  for (int64_t i = 0; i < (int64_t)dim; ++i) {
    double re = state[2 * i], im = state[2 * i + 1];
    total += re * re + im * im;
  }
  return total;
}

// Probability of outcome `measured` on `indices` (bit j of measured is
// qubit indices[j]).
template <typename T>
double measure_prob(int n, uint64_t measured, const int32_t* idx, int k,
                    const T* state) {
  const uint64_t dim = 1ull << n;
  uint64_t mask = 0, want = 0;
  for (int j = 0; j < k; ++j) {
    uint64_t pos = n - 1 - idx[j];
    mask |= 1ull << pos;
    if ((measured >> j) & 1ull) want |= 1ull << pos;
  }
  double total = 0;
#pragma omp parallel for reduction(+ : total) schedule(static)
  for (int64_t i = 0; i < (int64_t)dim; ++i) {
    if (((uint64_t)i & mask) == want) {
      double re = state[2 * i], im = state[2 * i + 1];
      total += re * re + im * im;
    }
  }
  return total;
}

// Collapse: zero mismatching rows, scale survivors by 1/sqrt(p).
template <typename T>
void measure_state(int n, uint64_t measured, double prob, const int32_t* idx,
                   int k, const T* in, T* out) {
  const uint64_t dim = 1ull << n;
  uint64_t mask = 0, want = 0;
  for (int j = 0; j < k; ++j) {
    uint64_t pos = n - 1 - idx[j];
    mask |= 1ull << pos;
    if ((measured >> j) & 1ull) want |= 1ull << pos;
  }
  if (prob <= 0) {
    std::memcpy(out, in, sizeof(T) * 2 * dim);
    return;
  }
  T scale = (T)(1.0 / std::sqrt(prob));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < (int64_t)dim; ++i) {
    if (((uint64_t)i & mask) == want) {
      out[2 * i] = in[2 * i] * scale;
      out[2 * i + 1] = in[2 * i + 1] * scale;
    } else {
      out[2 * i] = 0;
      out[2 * i + 1] = 0;
    }
  }
}

}  // namespace

extern "C" {

// float64 entry points
void qip_apply_dense_f64(int n, const int32_t* idx, int k, const double* mat,
                         const double* in, double* out) {
  apply_dense<double>(n, idx, k, mat, in, out);
}
void qip_apply_control_dense_f64(int n, const int32_t* cidx, int nc,
                                 const int32_t* tidx, int k, const double* mat,
                                 const double* in, double* out) {
  apply_control_dense<double>(n, cidx, nc, tidx, k, mat, in, out);
}
void qip_apply_swap_f64(int n, const int32_t* aidx, const int32_t* bidx,
                        int half, const double* in, double* out) {
  apply_swap<double>(n, aidx, bidx, half, in, out);
}
double qip_prob_magnitude_f64(int n, const double* state) {
  return prob_magnitude<double>(n, state);
}
double qip_measure_prob_f64(int n, uint64_t measured, const int32_t* idx,
                            int k, const double* state) {
  return measure_prob<double>(n, measured, idx, k, state);
}
void qip_measure_state_f64(int n, uint64_t measured, double prob,
                           const int32_t* idx, int k, const double* in,
                           double* out) {
  measure_state<double>(n, measured, prob, idx, k, in, out);
}

// float32 entry points (the c64 benchmark path)
void qip_apply_dense_f32(int n, const int32_t* idx, int k, const float* mat,
                         const float* in, float* out) {
  apply_dense<float>(n, idx, k, mat, in, out);
}
void qip_apply_control_dense_f32(int n, const int32_t* cidx, int nc,
                                 const int32_t* tidx, int k, const float* mat,
                                 const float* in, float* out) {
  apply_control_dense<float>(n, cidx, nc, tidx, k, mat, in, out);
}
void qip_apply_swap_f32(int n, const int32_t* aidx, const int32_t* bidx,
                        int half, const float* in, float* out) {
  apply_swap<float>(n, aidx, bidx, half, in, out);
}
double qip_prob_magnitude_f32(int n, const float* state) {
  return prob_magnitude<float>(n, state);
}
double qip_measure_prob_f32(int n, uint64_t measured, const int32_t* idx,
                            int k, const float* state) {
  return measure_prob<float>(n, measured, idx, k, state);
}
void qip_measure_state_f32(int n, uint64_t measured, double prob,
                           const int32_t* idx, int k, const float* in,
                           float* out) {
  measure_state<float>(n, measured, prob, idx, k, in, out);
}

int qip_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
