// Fused QFA prediction kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel qfa_tpu/ops/infer_kernel.py::_predict_kernel
// (Pallas; wrapper fused_predict). For each spectrum it computes the
// blue-side absorption A = exp(-tau(z)) and forest variance, the masked
// noise diagonal d = A^2 Psi + omega zdep + sigma^2, the capacitance
// K = I + sum_p w_p F_p F_p^T (w = A^2/d), the projection W = sum_p u_p F_p
// (u = A delta/d), the folded quad + logdet sum and n_obs; then the
// unrolled Cholesky, hmean = K^-1 W, the NLL and hcov = K^-1; then
// cont = mu + F hmean and std = sqrt(diag(F K^-1 F^T)).
//
// Design: one block of 256 threads per spectrum. Pass 1 strides the
// threads over the pixels; each thread forms the products F_pa F_pb of its
// pixel's F row in registers (no Gram matrix is stored anywhere) and keeps
// ntri + nh + 2 partial sums in registers, reduced by warp shuffles and
// one shared-memory step. Thread 0 factorizes K; threads 0..nh-1 then each
// build one column of K^-1. Pass 2 broadcasts hmean and the pre-doubled
// K^-1 triangle from shared memory to every pixel. The TPU kernel's
// lane-major stats block, 128-lane blue split, (rc, P) rhs matrix and
// batch tiles are TPU layout and have no counterpart here.
//
// What bounds it on an H100: per spectrum it reads flux and error
// (2 * 4 * Npix bytes, plus a mask or zabs plane when given) and writes
// continuum and std (2 * 4 * Npix bytes) — about 30 KB at SDSS width
// (Npix 1913) — and does a few hundred fp32 operations per pixel (the
// ntri + nh FMAs of each pass for nh = 8, the products F_pa F_pb, and the
// exp/pow tau chain on blue pixels). At 3.35 TB/s and 67 TFLOP/s fp32 the
// HBM traffic and the FP32 pipes are roughly balanced.
//
// Later work: the contractions are a (B, Npix) x (Npix, ntri) product
// that could run on the tensor cores, but TF32 keeps about three decimal
// digits; holding the tolerances would need 3xTF32 (split-precision)
// products or better.
//
// Build without -use_fast_math: __expf/__logf in the tau chain and in
// log(d) miss the tolerances.

#include <cuda_runtime.h>

#include <cstddef>

#include "smallchol.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;

struct PredictArgs {
  const float* flux;    // (N, npix)
  const float* error;   // (N, npix); 0 where masked when derive_mask
  const float* zabs;    // (N, zabs_ld) plane, or the (N, 2) zq column
  const float* mask;    // (N, npix), or null when derive_mask
  const float* mu;      // (npix,)
  const float* F;       // (npix, NH) row-major
  const float* psi;     // (npix,)
  const float* omega;   // (nb,)
  const float* loglam;  // (npix,) log(lam / lam_lya), derive_zabs only
  const float* tau0;    // () device scalars of the forest power law
  const float* c0;
  const float* beta;
  float law_a, law_b, law_c;  // tau law a (1+z)^b + c
  int npix, nb, zabs_ld;
  int derive_mask, derive_zabs;
  float* ll;     // (N,)
  float* n_obs;  // (N,)
  float* hmean;  // (N, NH)
  float* hcov;   // (N, NH, NH)
  float* cont;   // (N, npix), null when stats_only
  float* stdev;  // (N, npix), null when stats_only
};

template <int NH>
__global__ void __launch_bounds__(kThreads) predict_kernel(PredictArgs a) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NV = NT + NH + 2;  // [K tri | W | sum quad+logdet | n_obs]
  __shared__ float part[kWarps][NV];
  __shared__ float tot[NV];
  __shared__ float L[NH][NH];
  __shared__ float alpha_s[NH];
  __shared__ float kinv_tri[NT];

  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * a.npix;
  const float* zrow = a.zabs + static_cast<size_t>(row) * a.zabs_ld;
  const float tau0 = __ldg(a.tau0);
  const float c0 = __ldg(a.c0);
  const float beta = __ldg(a.beta);
  const float log1p_zq = a.derive_zabs ? __ldg(zrow) : 0.0f;

  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0f;

  float fr[NH];
  for (int p = threadIdx.x; p < a.npix; p += kThreads) {
    const float e = __ldg(a.error + base + p);
    const float m = a.derive_mask ? (e > 0.0f ? 1.0f : 0.0f)
                                  : __ldg(a.mask + base + p);
    const float f = __ldg(a.flux + base + p);
    // red pixels: amp = 1, zdep = 0
    float amp = 1.0f;
    float forest = 0.0f;  // omega_p * zdep
    if (p < a.nb) {
      float tau_line, zp1b;
      if (a.derive_zabs) {
        // log(1 + zabs) = log1p(zqso) + log(lam / lam_lya): no pow/log
        const float lz = log1p_zq + __ldg(a.loglam + p);
        tau_line = a.law_a * expf(a.law_b * lz) + a.law_c;
        zp1b = expf(beta * lz);
      } else {
        const float zp1 = 1.0f + __ldg(zrow + p);
        tau_line = a.law_a * powf(zp1, a.law_b) + a.law_c;
        zp1b = powf(zp1, beta);
      }
      amp = expf(-tau_line);
      const float root = 1.0f - c0 - expf(-(tau0 * zp1b));
      forest = __ldg(a.omega + p) * (root * root);
    }
    const float a2 = amp * amp;
    const float d = a2 * __ldg(a.psi + p) + forest + e * e;
    const float delta = (f - __ldg(a.mu + p) * amp) * m;
    // masked pixels: d_safe = 1, so dinv = 0 and log(d_safe) = 0
    const float d_safe = m > 0.0f ? d : 1.0f;
    const float dinv = m / d_safe;
    const float w = a2 * dinv;
    const float u = amp * dinv * delta;
    const float ql = delta * delta * dinv + m * logf(d_safe);
#pragma unroll
    for (int i = 0; i < NH; ++i) fr[i] = __ldg(a.F + static_cast<size_t>(p) * NH + i);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const float wi = w * fr[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[qfa::tri_idx(i, j)] += wi * fr[j];
      acc[NT + i] += u * fr[i];
    }
    acc[NT + NH] += ql;
    acc[NT + NH + 1] += m;
  }

  // block reduction: warp shuffles, then one shared-memory step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float x = acc[v];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[warp][v] = x;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < NV; v += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += part[k][v];
    tot[v] = s;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float k_tri[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) k_tri[t] = tot[t];
#pragma unroll
    for (int i = 0; i < NH; ++i) k_tri[qfa::tri_idx(i, i)] += 1.0f;
    float Lr[NH][NH];
    qfa::chol<NH>(k_tri, Lr);
    float wv[NH], y[NH], x[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) wv[i] = tot[NT + i];
    qfa::solve_lower<NH>(Lr, wv, y);
    qfa::solve_upper<NH>(Lr, y, x);
    float logdet = 0.0f, yy = 0.0f;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      logdet += logf(Lr[i][i]);
      yy += y[i] * y[i];
    }
    const float n_obs = tot[NT + NH + 1];
    a.ll[row] = 0.5f * (tot[NT + NH] - yy + n_obs * kLog2Pi + 2.0f * logdet);
    a.n_obs[row] = n_obs;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      a.hmean[static_cast<size_t>(row) * NH + i] = x[i];
      alpha_s[i] = x[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = Lr[i][j];
    }
  }
  __syncthreads();

  // one thread per column of K^-1 = hcov
  if (threadIdx.x < NH) {
    const int b = threadIdx.x;
    float x[NH];
    qfa::kinv_column<NH>(L, b, x);
    float* hc = a.hcov + static_cast<size_t>(row) * NH * NH;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      hc[i * NH + b] = x[i];
      // pre-doubled lower triangle for the symmetric variance contraction
      if (i >= b) kinv_tri[qfa::tri_idx(i, b)] = (i == b ? 1.0f : 2.0f) * x[i];
    }
  }
  __syncthreads();

  if (a.cont == nullptr) return;  // stats_only
  float al[NH], kt[NT];
#pragma unroll
  for (int i = 0; i < NH; ++i) al[i] = alpha_s[i];
#pragma unroll
  for (int t = 0; t < NT; ++t) kt[t] = kinv_tri[t];
  for (int p = threadIdx.x; p < a.npix; p += kThreads) {
#pragma unroll
    for (int i = 0; i < NH; ++i) fr[i] = __ldg(a.F + static_cast<size_t>(p) * NH + i);
    float c = 0.0f, var = 0.0f;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      c += al[i] * fr[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) var += kt[qfa::tri_idx(i, j)] * (fr[i] * fr[j]);
    }
    a.cont[base + p] = c + __ldg(a.mu + p);
    // var < 0 from rounding clamps to 0; a NaN stays NaN (fmaxf would not)
    a.stdev[base + p] = sqrtf(var < 0.0f ? 0.0f : var);
  }
}

template <int NH>
void launch(const PredictArgs& args, int n, cudaStream_t stream) {
  predict_kernel<NH><<<n, kThreads, 0, stream>>>(args);
}

}  // namespace

extern "C" {

// Launch the prediction kernel for n spectra on `stream` of `device`.
// Returns cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised. cont/stdev may be null (stats_only). nh must be 1..10.
int qfa_predict_f32(const float* flux, const float* error, const float* zabs,
                    int zabs_ld, const float* mask, const float* mu,
                    const float* F, const float* psi, const float* omega,
                    const float* loglam, const float* tau0, const float* c0,
                    const float* beta, float law_a, float law_b, float law_c,
                    int n, int npix, int nb, int nh, int derive_mask,
                    int derive_zabs, float* ll, float* n_obs, float* hmean,
                    float* hcov, float* cont, float* stdev, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const PredictArgs args{flux,  error, zabs,  mask,   mu,     F,      psi,
                         omega, loglam, tau0, c0,     beta,   law_a,  law_b,
                         law_c, npix,  nb,    zabs_ld, derive_mask,
                         derive_zabs, ll, n_obs, hmean, hcov, cont, stdev};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 1: launch<1>(args, n, s); break;
    case 2: launch<2>(args, n, s); break;
    case 3: launch<3>(args, n, s); break;
    case 4: launch<4>(args, n, s); break;
    case 5: launch<5>(args, n, s); break;
    case 6: launch<6>(args, n, s); break;
    case 7: launch<7>(args, n, s); break;
    case 8: launch<8>(args, n, s); break;
    case 9: launch<9>(args, n, s); break;
    case 10: launch<10>(args, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* qfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
