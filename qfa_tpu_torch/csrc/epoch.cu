// Whole-epoch QFA training kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel qfa_tpu/ops/epoch_kernel.py::_epoch_kernel
// (Pallas; wrapper fused_train_epoch). For every batch of every epoch of
// the call, with the batch's rows chosen through the tile permutation, it
// computes each spectrum's masked likelihood (blue-side absorption chain,
// noise diagonal d, weights w = A^2/d and u = A delta/d, the K triangle,
// W, Cholesky, NLL), the analytic backward (S = 1/2 (K^-1 + alpha
// alpha^T) with the off-diagonal doubled, the per-pixel cotangents dw and
// du, the accumulations dG = S^T w and dF = -alpha^T u, the cotangent dd
// of the noise diagonal and the rows of dPsi, domega, counts, dtau0, dc0
// and dbeta), then the count normalization, Adam with per-epoch bias
// correction and weight decay, and the clip to the parameter bounds.
//
// Design: the host loop below enqueues five stages per batch on the
// caller's stream; state (params, moments, scalars) lives in device
// buffers the wrapper owns and is updated in place between batches.
//   1. forward_kernel: one block of 256 threads per spectrum of the batch
//      (predict.cu's pass 1 with the training weights); thread 0
//      factorizes K (smallchol.cuh), threads 0..nh-1 build one column of
//      K^-1 each; writes S (packed triangle), alpha and the row's NLL,
//      has-blue flag and weight.
//   2. backward_kernel: one thread per pixel, one block row per chunk of
//      kChunk batch rows (S and -alpha of the chunk staged in shared
//      memory). Each thread recomputes its pixel's elementwise chain for
//      each row of its chunk, forms the Gram products F_pa F_pb once in
//      registers, and accumulates the chunk's gradient rows in
//      registers; writes one partial per (chunk, row, pixel).
//   3. books_kernel: one block sums the batch's NLL, has-blue flags and
//      weights in a fixed order (loss books and denominators).
//   4. update_kernel: one thread per pixel sums the chunk partials in
//      chunk order and runs Adam and the clip on F, Psi and omega; it
//      writes the pixel's dtau0/dc0/dbeta terms.
//   5. scalar_kernel: one block sums those terms over the pixels in a
//      fixed order and runs Adam and the clip on tau0, c0, beta.
// No float atomics anywhere: every sum has a fixed order, so k epochs in
// one call are bitwise equal to k chained calls. The TPU kernel's (rc, P)
// [tri(Gram) | F | ones] scratch, lane-major stats, 128-lane blue split
// and single (epoch, batch, tile) grid are TPU layout with no counterpart.
//
// mxu_bf16 rounds the operands of the six heavy products (K triangle, W,
// dw, du, dG, dF; the JAX kernel's dot_big) to bfloat16 with
// __float2bfloat16_rn and accumulates in fp32 (a product of two bf16
// values is exact in fp32); the sums of ql, the counts and the Cholesky
// chain stay fp32.
//
// What bounds it on an H100: per batch row and pixel, stage 1 and stage 2
// each read delta and error (8 bytes) and run the exp chain on blue pixels
// plus ~ntri + nh FMAs (stage 1) and ~2 (ntri + nh) FMAs (stage 2); at
// SDSS width (Npix 1913, nh 8) an epoch over 65,536 spectra reads ~2 GB
// and does ~40 GFLOP of fp32 work, so neither HBM (3.35 TB/s) nor the
// FP32 pipes (67 TFLOP/s) should bound it: launch count and occupancy
// do. Stage 2 runs ceil(Npix/128) x ceil(B/32) blocks (240 at SDSS width
// and batch 500): few SMs are busy and the scalar stages are one block.
// That is accepted for this first, simple kernel; tensor cores (wgmma)
// for the heavy products, fewer stages per batch and CUDA graphs are
// later work.
//
// Build without -use_fast_math: __expf/__logf in the tau chain and in
// log(d) miss the tolerances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "smallchol.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kPixThreads = 128;
constexpr int kChunk = 32;  // batch rows per backward block (_CHUNK_ROWS)
constexpr int kRedThreads = 256;
constexpr int kRedWarps = kRedThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;

// slots of the host hyper-parameter array (ops/epoch_kernel.py, _launch)
enum {
  HP_LAW_A, HP_LAW_B, HP_LAW_C, HP_EPS, HP_WD, HP_B1, HP_B2, HP_VMIN,
  HP_VMAX, HP_T0MIN, HP_T0MAX, HP_BMIN, HP_BMAX, HP_CMIN, HP_CMAX,
  HP_REFNORM
};
// slots of the device scalar state: value, m, v of tau0, c0, beta
enum { S_T0, S_C0, S_BETA, S_MT0, S_MC0, S_MBETA, S_VT0, S_VC0, S_VBETA };
// per-row stats written by stage 1: NLL, has-blue flag, weight
constexpr int kRowStat = 3;
// rows of the per-pixel accumulators after the NT + NH Gram/F rows
enum { A_PSI, A_OMEGA, A_CNT, A_T0, A_C0, A_BETA, A_EXTRA };

struct EpochArgs {
  const float* delta;   // (N, npix)
  const float* error;   // (N, npix); 0 where masked when derive_mask
  const float* zabs;    // (N, zabs_ld) plane, or the (N, 2) zq column
  const float* mask;    // (N, npix), or null when derive_mask
  const float* loglam;  // (npix,), derive_zabs only
  const int* perm;      // (n_epochs * n_tiles,) tile permutation
  float* F;             // (npix, NH) row-major, updated in place
  float* psi;           // (npix,)
  float* omega;         // (nb,)
  float* mF;
  float* vF;
  float* mpsi;
  float* vpsi;
  float* momega;
  float* vomega;
  float* scal;      // (9,) S_* slots
  float* S;         // (B, NT) packed S triangle, off-diagonal doubled
  float* alpha;     // (B, NH)
  float* rowstat;   // (B, kRowStat)
  float* partials;  // (n_chunks, NT + NH + A_EXTRA, npix)
  float* srows;     // (3, npix) dtau0, dc0, dbeta terms per pixel
  float* books;     // (4,) nll sum, scalar count, n_real
  float* loss_out;  // (n_epochs * n_batches,)
  float* nreal_out;
  float law_a, law_b, law_c, eps, wd, b1, b2;
  float vmin, vmax, t0min, t0max, bmin, bmax, cmin, cmax;
  int refnorm, mxu_bf16;
  int npix, nb, zabs_ld, derive_mask, derive_zabs;
  int tile_batch, batch_rows, n_chunks;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// operand of a heavy product: bf16-rounded under mxu_bf16
__device__ __forceinline__ float opnd(float x, int mxu) {
  return mxu ? bf16_round(x) : x;
}

// NaN-preserving clip (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// batch row r -> dataset row, through the tile permutation
__device__ __forceinline__ size_t batch_row(const EpochArgs& a, int base,
                                            int r) {
  const int tile = __ldg(a.perm + base + r / a.tile_batch);
  return static_cast<size_t>(tile) * a.tile_batch + (r % a.tile_batch);
}

// Elementwise terms of one (row, pixel): the JAX kernel's forward planes.
struct Pix {
  float m, w, u, q, dinv, d_safe;
  float amp, root, exp_neg, zp1b, log_zp1, zdep;  // blue pixels only
};

__device__ __forceinline__ Pix pixel_terms(const EpochArgs& a, size_t row,
                                           int p, float psi_p, float omega_p,
                                           float tau0, float c0, float beta) {
  const size_t off = row * a.npix + p;
  const float e = a.error[off];
  Pix x;
  x.m = a.derive_mask ? (e > 0.0f ? 1.0f : 0.0f) : a.mask[off];
  const float delta_m = a.delta[off] * x.m;
  float d;
  if (p < a.nb) {
    const float* zrow = a.zabs + row * a.zabs_ld;
    float tau_line;
    if (a.derive_zabs) {
      // log(1 + zabs) = log1p(zqso) + log(lam / lam_lya)
      const float lz = zrow[0] + a.loglam[p];
      tau_line = a.law_a * expf(a.law_b * lz) + a.law_c;
      x.zp1b = expf(beta * lz);
      x.log_zp1 = lz;
    } else {
      const float zp1 = 1.0f + zrow[p];
      tau_line = a.law_a * powf(zp1, a.law_b) + a.law_c;
      x.zp1b = powf(zp1, beta);
      x.log_zp1 = logf(zp1);
    }
    x.amp = expf(-tau_line);
    x.exp_neg = expf(-(tau0 * x.zp1b));
    x.root = 1.0f - c0 - x.exp_neg;
    x.zdep = x.root * x.root;
    d = x.amp * x.amp * psi_p + omega_p * x.zdep + e * e;
  } else {
    // red pixels: amp = 1, no forest term
    x.amp = 1.0f;
    x.root = x.exp_neg = x.zp1b = x.log_zp1 = x.zdep = 0.0f;
    d = psi_p + e * e;
  }
  // masked pixels: d_safe = 1, so dinv = 0 and log(d_safe) = 0
  x.d_safe = x.m > 0.0f ? d : 1.0f;
  x.dinv = x.m / x.d_safe;
  x.w = x.amp * x.amp * x.dinv;
  x.u = x.amp * x.dinv * delta_m;
  x.q = delta_m * delta_m * x.dinv;
  return x;
}

// Sum N values over a block of kRedThreads threads in a fixed order
// (warp shuffles, then warp partials in warp order). Result in tot.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (&part)[kRedWarps][N],
                                          float (&tot)[N]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kRedWarps; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---- stage 1: forward, factorization, S and alpha per spectrum ----------
template <int NH>
__global__ void __launch_bounds__(kFwdThreads)
    forward_kernel(EpochArgs a, int base) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NV = NT + NH + 3;  // [K tri | W | sum ql | n_obs | n_blue]
  __shared__ float part[kFwdWarps][NV];
  __shared__ float tot[NV];
  __shared__ float L[NH][NH];
  __shared__ float alpha_s[NH];

  const int r = blockIdx.x;
  const size_t row = batch_row(a, base, r);
  const float tau0 = a.scal[S_T0];
  const float c0 = a.scal[S_C0];
  const float beta = a.scal[S_BETA];
  const int mxu = a.mxu_bf16;

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
  float f[NH];
  for (int p = threadIdx.x; p < a.npix; p += kFwdThreads) {
    const float omega_p = p < a.nb ? a.omega[p] : 0.0f;
    const Pix x = pixel_terms(a, row, p, a.psi[p], omega_p, tau0, c0, beta);
    const float ql = x.q + x.m * logf(x.d_safe);
    const float wo = opnd(x.w, mxu);
    const float uo = opnd(x.u, mxu);
#pragma unroll
    for (int i = 0; i < NH; ++i) f[i] = a.F[static_cast<size_t>(p) * NH + i];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        acc[qfa::tri_idx(i, j)] += opnd(f[i] * f[j], mxu) * wo;
      acc[NT + i] += opnd(f[i], mxu) * uo;
    }
    acc[NT + NH] += ql;
    acc[NT + NH + 1] += x.m;
    if (p < a.nb) acc[NT + NH + 2] += x.m;
  }

  // block reduction: warp shuffles, then one shared-memory step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NV; k += kFwdThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w) s += part[w][k];
    tot[k] = s;
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
    float wv[NH], y[NH], al[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) wv[i] = tot[NT + i];
    qfa::solve_lower<NH>(Lr, wv, y);
    qfa::solve_upper<NH>(Lr, y, al);
    float logdet = 0.0f, yy = 0.0f;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      logdet += logf(Lr[i][i]);
      yy += y[i] * y[i];
    }
    const float n_obs = tot[NT + NH + 1];
    const float n_blue = tot[NT + NH + 2];
    float* rs = a.rowstat + static_cast<size_t>(r) * kRowStat;
    rs[0] = 0.5f * (tot[NT + NH] - yy + n_obs * kLog2Pi + 2.0f * logdet);
    rs[1] = n_blue > 0.5f ? 1.0f : 0.0f;
    // n_real: the zq column's weight in the derived layout, rows with an
    // observed pixel in the plane layout
    rs[2] = a.derive_zabs ? a.zabs[row * a.zabs_ld + 1]
                          : (n_obs > 0.5f ? 1.0f : 0.0f);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      alpha_s[i] = al[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = Lr[i][j];
    }
  }
  __syncthreads();

  // one thread per column b of K^-1: S[ab] = w_ab/2 (K^-1[ab] + al_a al_b)
  if (threadIdx.x < NH) {
    const int b = threadIdx.x;
    float col[NH];
    qfa::kinv_column<NH>(L, b, col);
    float* s = a.S + static_cast<size_t>(r) * NT;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      if (i >= b)
        s[qfa::tri_idx(i, b)] =
            (i == b ? 0.5f : 1.0f) * (col[i] + alpha_s[i] * alpha_s[b]);
    }
    a.alpha[static_cast<size_t>(r) * NH + b] = alpha_s[b];
  }
}

// ---- stage 2: per-pixel backward over one chunk of batch rows -----------
template <int NH>
__global__ void __launch_bounds__(kPixThreads)
    backward_kernel(EpochArgs a, int base) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NR = NT + NH + A_EXTRA;
  __shared__ float s_sm[kChunk][NT];
  __shared__ float na_sm[kChunk][NH];  // -alpha
  __shared__ size_t row_sm[kChunk];

  const int mxu = a.mxu_bf16;
  const int r0 = blockIdx.y * kChunk;
  const int nr = min(kChunk, a.batch_rows - r0);
  for (int k = threadIdx.x; k < nr * NT; k += kPixThreads)
    s_sm[k / NT][k % NT] = opnd(a.S[static_cast<size_t>(r0) * NT + k], mxu);
  for (int k = threadIdx.x; k < nr * NH; k += kPixThreads)
    na_sm[k / NH][k % NH] =
        opnd(-a.alpha[static_cast<size_t>(r0) * NH + k], mxu);
  for (int k = threadIdx.x; k < nr; k += kPixThreads)
    row_sm[k] = batch_row(a, base, r0 + k);
  __syncthreads();

  const int p = blockIdx.x * kPixThreads + threadIdx.x;
  if (p >= a.npix) return;
  const float tau0 = a.scal[S_T0];
  const float c0 = a.scal[S_C0];
  const float beta = a.scal[S_BETA];
  const bool blue = p < a.nb;
  const float psi_p = a.psi[p];
  const float omega_p = blue ? a.omega[p] : 0.0f;
  float g[NT], fo[NH];
  {
    float f[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) f[i] = a.F[static_cast<size_t>(p) * NH + i];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      fo[i] = opnd(f[i], mxu);
#pragma unroll
      for (int j = 0; j <= i; ++j) g[qfa::tri_idx(i, j)] = opnd(f[i] * f[j], mxu);
    }
  }
  float acc[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) acc[k] = 0.0f;
  constexpr int X = NT + NH;
  for (int r = 0; r < nr; ++r) {
    const Pix x = pixel_terms(a, row_sm[r], p, psi_p, omega_p, tau0, c0, beta);
    float dw = 0.0f, du = 0.0f;
#pragma unroll
    for (int t = 0; t < NT; ++t) dw += s_sm[r][t] * g[t];
#pragma unroll
    for (int i = 0; i < NH; ++i) du += na_sm[r][i] * fo[i];
    const float dd = (-(dw * x.w + du * x.u + 0.5f * x.q) + 0.5f * x.m) * x.dinv;
    const float wo = opnd(x.w, mxu);
    const float uo = opnd(x.u, mxu);
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] += s_sm[r][t] * wo;
#pragma unroll
    for (int i = 0; i < NH; ++i) acc[NT + i] += na_sm[r][i] * uo;
    if (blue) {
      const float droot2 = dd * omega_p * 2.0f * x.root;
      const float dtz = droot2 * x.exp_neg * x.zp1b;
      acc[X + A_PSI] += dd * x.amp * x.amp;
      acc[X + A_OMEGA] += dd * x.zdep;
      acc[X + A_T0] += dtz;
      acc[X + A_C0] += droot2;
      acc[X + A_BETA] += dtz * x.log_zp1;
    } else {
      acc[X + A_PSI] += dd;
    }
    acc[X + A_CNT] += x.m;
  }
  float* out = a.partials + static_cast<size_t>(blockIdx.y) * NR * a.npix + p;
#pragma unroll
  for (int k = 0; k < NR; ++k) out[static_cast<size_t>(k) * a.npix] = acc[k];
}

// ---- stage 3: the batch's loss books ------------------------------------
__global__ void __launch_bounds__(kRedThreads)
    books_kernel(EpochArgs a, int out_idx) {
  __shared__ float part[kRedWarps][kRowStat];
  __shared__ float tot[kRowStat];
  float v[kRowStat] = {0.0f, 0.0f, 0.0f};
  for (int r = threadIdx.x; r < a.batch_rows; r += kRedThreads) {
#pragma unroll
    for (int k = 0; k < kRowStat; ++k)
      v[k] += a.rowstat[static_cast<size_t>(r) * kRowStat + k];
  }
  block_sum<kRowStat>(v, part, tot);
  if (threadIdx.x == 0) {
    a.books[0] = tot[0];  // summed NLL
    a.books[1] = tot[1];  // rows with an observed blue pixel
    a.books[2] = tot[2];  // n_real
    a.loss_out[out_idx] = tot[0];
    a.nreal_out[out_idx] = tot[2];
  }
}

// ---- stage 4: per-pixel Adam and clip of F, Psi, omega ------------------
template <int NH>
__global__ void __launch_bounds__(kPixThreads)
    update_kernel(EpochArgs a, float lr, float bc1, float bc2) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NR = NT + NH + A_EXTRA;
  constexpr int X = NT + NH;
  const int p = blockIdx.x * kPixThreads + threadIdx.x;
  if (p >= a.npix) return;
  float acc[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) acc[k] = 0.0f;
  for (int c = 0; c < a.n_chunks; ++c) {
    const float* in = a.partials + static_cast<size_t>(c) * NR * a.npix + p;
#pragma unroll
    for (int k = 0; k < NR; ++k) acc[k] += in[static_cast<size_t>(k) * a.npix];
  }
  const float n_real = fmaxf(a.books[2], 1.0f);
  const float cnt = acc[X + A_CNT];
  float denom, zero;
  if (a.refnorm) {
    denom = fmaxf(cnt, 1.0f);
    zero = cnt > 0.0f ? 1.0f : 0.0f;  // never-observed pixels: gradient 0
  } else {
    denom = n_real;
    zero = 1.0f;
  }
  const float omb1 = 1.0f - a.b1;
  const float omb2 = 1.0f - a.b2;
  auto adam = [&](float prm, float grad, float& mo, float& ve) {
    const float gg = grad + a.wd * prm;
    mo = omb1 * gg + a.b1 * mo;
    ve = omb2 * gg * gg + a.b2 * ve;
    return prm - lr * (mo / bc1) / (sqrtf(ve / bc2) + a.eps);
  };
  {
    float mo = a.mpsi[p], ve = a.vpsi[p];
    const float pn = adam(a.psi[p], acc[X + A_PSI] / denom * zero, mo, ve);
    a.psi[p] = clip(pn, a.vmin, a.vmax);
    a.mpsi[p] = mo;
    a.vpsi[p] = ve;
  }
  if (p < a.nb) {  // omega exists only on blue pixels
    float mo = a.momega[p], ve = a.vomega[p];
    const float on = adam(a.omega[p], acc[X + A_OMEGA] / denom * zero, mo, ve);
    a.omega[p] = clip(on, a.vmin, a.vmax);
    a.momega[p] = mo;
    a.vomega[p] = ve;
  }
  // dF[a] = dRHS_F[a] + sum_b dG[ab] F[b] with the old F (the diagonal
  // triangle entry counts twice, the off-diagonal ones hold dG[ab]+dG[ba])
  float f[NH], fn[NH];
  float* fp = a.F + static_cast<size_t>(p) * NH;
#pragma unroll
  for (int i = 0; i < NH; ++i) f[i] = fp[i];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float df = acc[NT + i];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float dg = acc[qfa::tri_idx(i, j)];
      if (i == j) dg = dg + dg;
      df = df + dg * f[j];
    }
    df = df / denom * zero;
    const size_t k = static_cast<size_t>(p) * NH + i;
    float mo = a.mF[k], ve = a.vF[k];
    fn[i] = adam(f[i], df, mo, ve);
    a.mF[k] = mo;
    a.vF[k] = ve;
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) fp[i] = fn[i];
  if (p < a.nb) {
    a.srows[p] = acc[X + A_T0];
    a.srows[a.npix + p] = -acc[X + A_C0];
    a.srows[2 * a.npix + p] = a.scal[S_T0] * acc[X + A_BETA];
  }
}

// ---- stage 5: scalar gradients over the pixels, Adam and clip -----------
__global__ void __launch_bounds__(kRedThreads)
    scalar_kernel(EpochArgs a, float lr, float bc1, float bc2) {
  __shared__ float part[kRedWarps][3];
  __shared__ float tot[3];
  float v[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < a.nb; p += kRedThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] += a.srows[static_cast<size_t>(k) * a.npix + p];
  }
  block_sum<3>(v, part, tot);
  if (threadIdx.x != 0) return;
  const float sdenom = a.refnorm ? fmaxf(a.books[1], 1.0f)
                                 : fmaxf(a.books[2], 1.0f);
  const float lo[3] = {a.t0min, a.cmin, a.bmin};
  const float hi[3] = {a.t0max, a.cmax, a.bmax};
  const float omb1 = 1.0f - a.b1;
  const float omb2 = 1.0f - a.b2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // tau0, c0, beta
    const float prm = a.scal[S_T0 + k];
    const float gg = tot[k] / sdenom + a.wd * prm;
    const float mo = omb1 * gg + a.b1 * a.scal[S_MT0 + k];
    const float ve = omb2 * gg * gg + a.b2 * a.scal[S_VT0 + k];
    const float pn = prm - lr * (mo / bc1) / (sqrtf(ve / bc2) + a.eps);
    a.scal[S_T0 + k] = clip(pn, lo[k], hi[k]);
    a.scal[S_MT0 + k] = mo;
    a.scal[S_VT0 + k] = ve;
  }
}

template <int NH>
cudaError_t run(const EpochArgs& args, const float* sched, int n_tiles,
                int tiles_per_batch, int n_batches, int n_epochs,
                cudaStream_t s) {
  const dim3 pix_grid((args.npix + kPixThreads - 1) / kPixThreads);
  const dim3 bwd_grid(pix_grid.x, args.n_chunks);
  for (int e = 0; e < n_epochs; ++e) {
    const float lr = sched[3 * e], bc1 = sched[3 * e + 1],
                bc2 = sched[3 * e + 2];
    for (int i = 0; i < n_batches; ++i) {
      const int base = e * n_tiles + i * tiles_per_batch;
      forward_kernel<NH><<<args.batch_rows, kFwdThreads, 0, s>>>(args, base);
      backward_kernel<NH><<<bwd_grid, kPixThreads, 0, s>>>(args, base);
      books_kernel<<<1, kRedThreads, 0, s>>>(args, e * n_batches + i);
      update_kernel<NH><<<pix_grid, kPixThreads, 0, s>>>(args, lr, bc1, bc2);
      scalar_kernel<<<1, kRedThreads, 0, s>>>(args, lr, bc1, bc2);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Run n_epochs training epochs of n_batches batches each on `stream` of
// `device`, updating F..vomega and scal in place and writing the per-batch
// loss sums and n_real. hp (host, HP_* slots) and sched (host, (n_epochs,
// 3) lr, bc1, bc2) are read here; every other pointer is device memory.
// Returns the first cudaGetLastError() that is not cudaSuccess (0 =
// every stage launched); nothing is synchronised. nh must be 1..10.
int qfa_train_epoch_f32(
    const float* delta, const float* error, const float* zabs, int zabs_ld,
    const float* mask, const float* loglam, const int* perm, int n_tiles,
    int tile_batch, int tiles_per_batch, int n_batches, int n_epochs,
    int npix, int nb, int nh, int derive_mask, int derive_zabs, int mxu_bf16,
    float* F, float* psi, float* omega, float* mF, float* vF, float* mpsi,
    float* vpsi, float* momega, float* vomega, float* scal, const float* hp,
    const float* sched, float* S, float* alpha, float* rowstat,
    float* partials, float* srows, float* books, float* loss_out,
    float* nreal_out, int n_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int batch_rows = tiles_per_batch * tile_batch;
  if (batch_rows <= 0 || n_batches <= 0 || n_epochs <= 0 ||
      n_chunks != (batch_rows + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  EpochArgs args;
  args.delta = delta;
  args.error = error;
  args.zabs = zabs;
  args.mask = mask;
  args.loglam = loglam;
  args.perm = perm;
  args.F = F;
  args.psi = psi;
  args.omega = omega;
  args.mF = mF;
  args.vF = vF;
  args.mpsi = mpsi;
  args.vpsi = vpsi;
  args.momega = momega;
  args.vomega = vomega;
  args.scal = scal;
  args.S = S;
  args.alpha = alpha;
  args.rowstat = rowstat;
  args.partials = partials;
  args.srows = srows;
  args.books = books;
  args.loss_out = loss_out;
  args.nreal_out = nreal_out;
  args.law_a = hp[HP_LAW_A];
  args.law_b = hp[HP_LAW_B];
  args.law_c = hp[HP_LAW_C];
  args.eps = hp[HP_EPS];
  args.wd = hp[HP_WD];
  args.b1 = hp[HP_B1];
  args.b2 = hp[HP_B2];
  args.vmin = hp[HP_VMIN];
  args.vmax = hp[HP_VMAX];
  args.t0min = hp[HP_T0MIN];
  args.t0max = hp[HP_T0MAX];
  args.bmin = hp[HP_BMIN];
  args.bmax = hp[HP_BMAX];
  args.cmin = hp[HP_CMIN];
  args.cmax = hp[HP_CMAX];
  args.refnorm = hp[HP_REFNORM] > 0.0f ? 1 : 0;
  args.mxu_bf16 = mxu_bf16;
  args.npix = npix;
  args.nb = nb;
  args.zabs_ld = zabs_ld;
  args.derive_mask = derive_mask;
  args.derive_zabs = derive_zabs;
  args.tile_batch = tile_batch;
  args.batch_rows = batch_rows;
  args.n_chunks = n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 1: err = run<1>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 2: err = run<2>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 3: err = run<3>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 4: err = run<4>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 5: err = run<5>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 6: err = run<6>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 7: err = run<7>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 8: err = run<8>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 9: err = run<9>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    case 10: err = run<10>(args, sched, n_tiles, tiles_per_batch, n_batches, n_epochs, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
