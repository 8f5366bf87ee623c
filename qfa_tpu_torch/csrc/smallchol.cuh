// Small dense linear algebra shared by the QFA kernels: the unrolled
// Cholesky factorization of an NH x NH SPD matrix, its two triangular
// solves, the columns of K^-1, and the packed lower-triangle indexing.
//
// Device counterparts of the JAX package's in-kernel helpers
// (qfa_tpu/ops/fused_step.py: _chol_t, _solve_lower_t, _solve_upper_t;
// qfa_tpu/ops/epoch_kernel.py: _kinv_column, _tri_pairs, _tri_idx), in
// the same operation order, so the kernels factorize exactly as the plain
// torch path (qfa_tpu_torch/linalg/smallchol.py) does up to fp32 rounding.
// NH is a template parameter: every loop unrolls and every matrix entry
// lives in a register (or in shared memory where the caller puts it).
#pragma once

namespace qfa {

__host__ __device__ constexpr int ntri(int nh) { return nh * (nh + 1) / 2; }

// Packed index of (a, b) in the lower triangle, row-major over a >= b:
// (0,0) (1,0) (1,1) (2,0) ... — the order of _tri_pairs. Symmetric.
__host__ __device__ constexpr int tri_idx(int a, int b) {
  return a >= b ? a * (a + 1) / 2 + b : b * (b + 1) / 2 + a;
}

// Lower Cholesky factor L of K, with K given as its packed lower triangle.
// The strictly upper part of L is left untouched.
template <int NH>
__device__ __forceinline__ void chol(const float* k_tri, float (&L)[NH][NH]) {
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    float s = k_tri[tri_idx(j, j)];
#pragma unroll
    for (int p = 0; p < j; ++p) s -= L[j][p] * L[j][p];
    const float d = sqrtf(s);
    const float inv_d = 1.0f / d;
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < NH; ++i) {
      float t = k_tri[tri_idx(i, j)];
#pragma unroll
      for (int p = 0; p < j; ++p) t -= L[i][p] * L[j][p];
      L[i][j] = t * inv_d;
    }
  }
}

// Forward substitution: L y = b.
template <int NH>
__device__ __forceinline__ void solve_lower(const float (&L)[NH][NH],
                                            const float* b, float* y) {
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float s = b[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s -= L[i][j] * y[j];
    y[i] = s / L[i][i];
  }
}

// Back substitution: L^T x = y.
template <int NH>
__device__ __forceinline__ void solve_upper(const float (&L)[NH][NH],
                                            const float* y, float* x) {
#pragma unroll
  for (int i = NH - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int j = i + 1; j < NH; ++j) s -= L[j][i] * x[j];
    x[i] = s / L[i][i];
  }
}

// Column b of K^-1 = (L L^T)^-1. The forward solve of L y = e_b has
// y_i = 0 exactly for i < b, so those terms are skipped (the unit-RHS
// shortcut of _kinv_column). b is a run-time value (one thread per
// column); the loops stay unrolled over the static NH.
template <int NH>
__device__ __forceinline__ void kinv_column(const float (&L)[NH][NH], int b,
                                            float* x) {
  float y[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      if (j >= b) s -= L[i][j] * y[j];
    }
    y[i] = i < b ? 0.0f : (i == b ? 1.0f / L[i][i] : s / L[i][i]);
  }
  solve_upper<NH>(L, y, x);
}

// The same three steps with the reciprocals of L's diagonal precomputed:
// each division by L[i][i] becomes a product (one rounding apart from the
// division), which shortens the serial chain of one thread's factorization.
template <int NH>
__device__ __forceinline__ void chol_rdiag(const float* k_tri,
                                           float (&L)[NH][NH],
                                           float (&rd)[NH]) {
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    float s = k_tri[tri_idx(j, j)];
#pragma unroll
    for (int p = 0; p < j; ++p) s -= L[j][p] * L[j][p];
    const float d = sqrtf(s);
    rd[j] = 1.0f / d;
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < NH; ++i) {
      float t = k_tri[tri_idx(i, j)];
#pragma unroll
      for (int p = 0; p < j; ++p) t -= L[i][p] * L[j][p];
      L[i][j] = t * rd[j];
    }
  }
}

template <int NH>
__device__ __forceinline__ void solve_lower_rdiag(const float (&L)[NH][NH],
                                                  const float (&rd)[NH],
                                                  const float* b, float* y) {
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float s = b[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s -= L[i][j] * y[j];
    y[i] = s * rd[i];
  }
}

template <int NH>
__device__ __forceinline__ void solve_upper_rdiag(const float (&L)[NH][NH],
                                                  const float (&rd)[NH],
                                                  const float* y, float* x) {
#pragma unroll
  for (int i = NH - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int j = i + 1; j < NH; ++j) s -= L[j][i] * x[j];
    x[i] = s * rd[i];
  }
}

// Column b of L^-1: the forward solve of L y = e_b, y_i = 0 for i < b.
template <int NH>
__device__ __forceinline__ void linv_column_rdiag(const float (&L)[NH][NH],
                                                  const float (&rd)[NH],
                                                  int b, float* y) {
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      if (j >= b) s -= L[i][j] * y[j];
    }
    y[i] = i < b ? 0.0f : (i == b ? rd[i] : s * rd[i]);
  }
}

template <int NH>
__device__ __forceinline__ void kinv_column_rdiag(const float (&L)[NH][NH],
                                                  const float (&rd)[NH],
                                                  int b, float* x) {
  float y[NH];
  linv_column_rdiag<NH>(L, rd, b, y);
  solve_upper_rdiag<NH>(L, rd, y, x);
}

}  // namespace qfa
