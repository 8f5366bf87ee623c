// Per-step QFA loss and gradient kernel for Hopper (sm_90a), bound with
// ctypes.
//
// Replaces the TPU kernel qfa_tpu/ops/fused_step.py::_step_kernel (Pallas;
// wrapper fused_loss_grads) together with that wrapper's lane-direction
// sums and finish_f_gradient. For one batch it computes each spectrum's
// masked likelihood (blue-side absorption chain, noise diagonal d, weights
// w = A^2/d and u = A delta/d with the mask multiplied by the row's
// weight, the K triangle, W, Cholesky, NLL), the analytic backward (S =
// 1/2 (K^-1 + alpha alpha^T), the per-pixel cotangents dw = F_p^T S F_p
// and du = -alpha F_p, the cotangent dd of the noise diagonal) and returns
// the summed NLL, the summed gradients of F, Psi, omega, tau0, c0 and beta,
// the per-pixel counts and the count of rows with an observed blue pixel.
// No optimizer: normalization, Adam, clip and the guard run in torch.
//
// Design: the C entry enqueues four stages on the caller's stream.
//   1. forward_kernel: one block of 256 threads per batch row (epoch.cu
//      stage 1, predict.cu pass 1); thread 0 factorizes K
//      (smallchol.cuh), threads 0..nh-1 build one column of K^-1 each;
//      writes S (packed triangle, off-diagonal doubled), alpha and the
//      row's NLL and has-blue flag.
//   2. backward_kernel: one thread per pixel, one block row per chunk of
//      kChunk batch rows (S, -alpha and the row weights of the chunk in
//      shared memory); each thread recomputes its pixel's chain per row and
//      accumulates dG, dF, dPsi, domega, the count and the dtau0, dc0,
//      dbeta terms in registers; writes one partial per (chunk, pixel).
//   3. finish_kernel: one thread per pixel sums the partials in chunk
//      order and finishes dF[p,a] = sum_b dG[ab] F[p,b] + dF_direct[p,a]
//      (finish_f_gradient; the doubled off-diagonal of the triangle holds
//      dG[ab] + dG[ba], the diagonal counts twice) in registers.
//   4. books_kernel: one block sums the NLL, the has-blue flags and the
//      per-pixel scalar terms in a fixed order.
// No float atomics anywhere: every sum has a fixed order, so the result
// does not depend on scheduling. The TPU kernel's full nh^2 Gram in an
// (P, RC) [Gram | F | ones | blue] RHS, its (8, P) row accumulators, tiles
// of the batch and sequential grid are TPU layout with no counterpart; the
// tile size therefore has no meaning here.
//
// What bounds it on an H100: at SDSS width (Npix 1913, Nb 720, nh 8) and
// batch 500 the inputs are 13 MB (delta, error, mask, zabs) and the
// products ~0.25 GFLOP of fp32 FMAs, so a read-once floor of ~4 us on HBM
// and ~4 us on the FP32 pipes. This design reads the planes twice and
// writes and reads ~6 MB of chunk partials, and runs 4 launches of which
// two are small (16 pixel blocks, one reduction block): launch latency and
// occupancy bound it, as for epoch.cu. Several rows per block, tensor
// cores and fewer stages are later work.
//
// Build without -use_fast_math: __expf/__logf in the tau chain and in
// log(d) miss the tolerances.

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

// per-row stats written by stage 1: NLL, has-blue flag
constexpr int kRowStat = 2;
// rows of the per-pixel partials after the NT + NH Gram/F rows
enum { A_PSI, A_OMEGA, A_CNT, A_T0, A_C0, A_BETA, A_EXTRA };
// slots of the small output: loss sum, scalar count, dtau0, dc0, dbeta
enum { O_LOSS, O_SCOUNT, O_T0, O_C0, O_BETA, O_N };

struct StepArgs {
  const float* delta;   // (B, npix)
  const float* error;   // (B, npix)
  const float* zabs;    // (B, zabs_ld), read on the nb blue pixels
  const float* mask;    // (B, npix)
  const float* weight;  // (B,) 0 on padding rows
  const float* F;       // (npix, NH) row-major
  const float* psi;     // (npix,)
  const float* omega;   // (nb,)
  const float* tau0;    // () device scalars of the forest power law
  const float* c0;
  const float* beta;
  float* S;         // (B, NT) packed S triangle, off-diagonal doubled
  float* alpha;     // (B, NH)
  float* rowstat;   // (B, kRowStat)
  float* partials;  // (n_chunks, NT + NH + A_EXTRA, npix)
  float* srows;     // (3, nb) dtau0, dc0, dbeta terms per pixel
  float* gF;        // (npix, NH) outputs
  float* gpsi;      // (npix,)
  float* gomega;    // (nb,)
  float* counts;    // (npix,)
  float* out;       // (O_N,)
  float law_a, law_b, law_c;
  int batch_rows, npix, nb, zabs_ld, n_chunks;
};

// Elementwise terms of one (row, pixel): the JAX kernel's forward planes.
struct Pix {
  float m, w, u, q, d_safe;
  float amp, root, exp_neg, zp1b, log_zp1, zdep;  // blue pixels only
  float dinv;
};

// The JAX wrapper multiplies delta by the mask, then the mask by the row's
// weight (weight-0 rows are inert), and the kernel forms delta * m.
__device__ __forceinline__ Pix pixel_terms(const StepArgs& a, int row,
                                           float wt, int p, float psi_p,
                                           float omega_p, float tau0,
                                           float c0, float beta) {
  const size_t off = static_cast<size_t>(row) * a.npix + p;
  const float e = a.error[off];
  const float mk = a.mask[off];
  Pix x;
  x.m = mk * wt;
  const float delta_m = (a.delta[off] * mk) * x.m;
  float d;
  if (p < a.nb) {
    const float zp1 = 1.0f + a.zabs[static_cast<size_t>(row) * a.zabs_ld + p];
    const float tau_line = a.law_a * powf(zp1, a.law_b) + a.law_c;
    x.zp1b = powf(zp1, beta);
    x.log_zp1 = logf(zp1);
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

// ---- stage 1: forward, factorization, S and alpha per batch row --------
template <int NH>
__global__ void __launch_bounds__(kFwdThreads) forward_kernel(StepArgs a) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NV = NT + NH + 3;  // [K tri | W | sum ql | n_obs | n_blue]
  __shared__ float part[kFwdWarps][NV];
  __shared__ float tot[NV];
  __shared__ float L[NH][NH];
  __shared__ float alpha_s[NH];

  const int r = blockIdx.x;
  const float wt = a.weight[r];
  const float tau0 = *a.tau0;
  const float c0 = *a.c0;
  const float beta = *a.beta;

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
  float f[NH];
  for (int p = threadIdx.x; p < a.npix; p += kFwdThreads) {
    const float omega_p = p < a.nb ? a.omega[p] : 0.0f;
    const Pix x = pixel_terms(a, r, wt, p, a.psi[p], omega_p, tau0, c0, beta);
    const float ql = x.q + x.m * logf(x.d_safe);
#pragma unroll
    for (int i = 0; i < NH; ++i) f[i] = a.F[static_cast<size_t>(p) * NH + i];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[qfa::tri_idx(i, j)] += f[i] * f[j] * x.w;
      acc[NT + i] += f[i] * x.u;
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
    // the scalar count: rows with an observed blue pixel after mask*weight
    rs[1] = n_blue > 0.5f ? 1.0f : 0.0f;
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
__global__ void __launch_bounds__(kPixThreads) backward_kernel(StepArgs a) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NR = NT + NH + A_EXTRA;
  __shared__ float s_sm[kChunk][NT];
  __shared__ float na_sm[kChunk][NH];  // -alpha
  __shared__ float w_sm[kChunk];

  const int r0 = blockIdx.y * kChunk;
  const int nr = min(kChunk, a.batch_rows - r0);
  for (int k = threadIdx.x; k < nr * NT; k += kPixThreads)
    s_sm[k / NT][k % NT] = a.S[static_cast<size_t>(r0) * NT + k];
  for (int k = threadIdx.x; k < nr * NH; k += kPixThreads)
    na_sm[k / NH][k % NH] = -a.alpha[static_cast<size_t>(r0) * NH + k];
  for (int k = threadIdx.x; k < nr; k += kPixThreads)
    w_sm[k] = a.weight[r0 + k];
  __syncthreads();

  const int p = blockIdx.x * kPixThreads + threadIdx.x;
  if (p >= a.npix) return;
  const float tau0 = *a.tau0;
  const float c0 = *a.c0;
  const float beta = *a.beta;
  const bool blue = p < a.nb;
  const float psi_p = a.psi[p];
  const float omega_p = blue ? a.omega[p] : 0.0f;
  float g[NT], f[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) f[i] = a.F[static_cast<size_t>(p) * NH + i];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) g[qfa::tri_idx(i, j)] = f[i] * f[j];
  }
  float acc[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) acc[k] = 0.0f;
  constexpr int X = NT + NH;
  for (int r = 0; r < nr; ++r) {
    const Pix x = pixel_terms(a, r0 + r, w_sm[r], p, psi_p, omega_p, tau0, c0,
                              beta);
    float dw = 0.0f, du = 0.0f;
#pragma unroll
    for (int t = 0; t < NT; ++t) dw += s_sm[r][t] * g[t];
#pragma unroll
    for (int i = 0; i < NH; ++i) du += na_sm[r][i] * f[i];
    const float dd = (-(dw * x.w + du * x.u + 0.5f * x.q) + 0.5f * x.m) * x.dinv;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] += s_sm[r][t] * x.w;
#pragma unroll
    for (int i = 0; i < NH; ++i) acc[NT + i] += na_sm[r][i] * x.u;
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

// ---- stage 3: chunk partials -> finished per-pixel gradients -----------
template <int NH>
__global__ void __launch_bounds__(kPixThreads) finish_kernel(StepArgs a) {
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
  // dF[a] = dRHS_F[a] + sum_b dG[ab] F[b] (the diagonal triangle entry
  // counts twice, the off-diagonal ones hold dG[ab] + dG[ba])
  float f[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) f[i] = a.F[static_cast<size_t>(p) * NH + i];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float df = acc[NT + i];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float dg = acc[qfa::tri_idx(i, j)];
      if (i == j) dg = dg + dg;
      df = df + dg * f[j];
    }
    a.gF[static_cast<size_t>(p) * NH + i] = df;
  }
  a.gpsi[p] = acc[X + A_PSI];
  a.counts[p] = acc[X + A_CNT];
  if (p < a.nb) {
    a.gomega[p] = acc[X + A_OMEGA];
    a.srows[p] = acc[X + A_T0];
    a.srows[a.nb + p] = -acc[X + A_C0];
    a.srows[2 * a.nb + p] = *a.tau0 * acc[X + A_BETA];
  }
}

// ---- stage 4: loss, scalar count and scalar gradients -------------------
__global__ void __launch_bounds__(kRedThreads) books_kernel(StepArgs a) {
  constexpr int N = kRowStat + 3;
  __shared__ float part[kRedWarps][N];
  __shared__ float tot[N];
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.0f;
  for (int r = threadIdx.x; r < a.batch_rows; r += kRedThreads) {
#pragma unroll
    for (int k = 0; k < kRowStat; ++k)
      v[k] += a.rowstat[static_cast<size_t>(r) * kRowStat + k];
  }
  for (int p = threadIdx.x; p < a.nb; p += kRedThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[kRowStat + k] += a.srows[static_cast<size_t>(k) * a.nb + p];
  }
  block_sum<N>(v, part, tot);
  if (threadIdx.x == 0) {
    a.out[O_LOSS] = tot[0];
    a.out[O_SCOUNT] = tot[1];
    a.out[O_T0] = tot[2];
    a.out[O_C0] = tot[3];
    a.out[O_BETA] = tot[4];
  }
}

template <int NH>
cudaError_t run(const StepArgs& args, cudaStream_t s) {
  const dim3 pix_grid((args.npix + kPixThreads - 1) / kPixThreads);
  const dim3 bwd_grid(pix_grid.x, args.n_chunks);
  forward_kernel<NH><<<args.batch_rows, kFwdThreads, 0, s>>>(args);
  backward_kernel<NH><<<bwd_grid, kPixThreads, 0, s>>>(args);
  finish_kernel<NH><<<pix_grid, kPixThreads, 0, s>>>(args);
  books_kernel<<<1, kRedThreads, 0, s>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Loss and summed gradients of one batch of batch_rows rows on `stream` of
// `device`. Every pointer is device memory: the batch planes, the
// parameters (tau0, c0, beta as device scalars), the scratch (S, alpha,
// rowstat, partials, srows) and the outputs (gF, gpsi, gomega, counts and
// out = [loss sum, scalar count, dtau0, dc0, dbeta]). Returns the first
// cudaGetLastError() that is not cudaSuccess (0 = every stage launched);
// nothing is synchronised. nh must be 1..10.
int qfa_step_f32(
    const float* delta, const float* error, const float* zabs, int zabs_ld,
    const float* mask, const float* weight, const float* F, const float* psi,
    const float* omega, const float* tau0, const float* c0, const float* beta,
    float law_a, float law_b, float law_c, int batch_rows, int npix, int nb,
    int nh, float* S, float* alpha, float* rowstat, float* partials,
    float* srows, float* gF, float* gpsi, float* gomega, float* counts,
    float* out, int n_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch_rows <= 0 || npix <= 0 || nb < 0 || nb > npix || zabs_ld < nb ||
      n_chunks != (batch_rows + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs args;
  args.delta = delta;
  args.error = error;
  args.zabs = zabs;
  args.mask = mask;
  args.weight = weight;
  args.F = F;
  args.psi = psi;
  args.omega = omega;
  args.tau0 = tau0;
  args.c0 = c0;
  args.beta = beta;
  args.S = S;
  args.alpha = alpha;
  args.rowstat = rowstat;
  args.partials = partials;
  args.srows = srows;
  args.gF = gF;
  args.gpsi = gpsi;
  args.gomega = gomega;
  args.counts = counts;
  args.out = out;
  args.law_a = law_a;
  args.law_b = law_b;
  args.law_c = law_c;
  args.batch_rows = batch_rows;
  args.npix = npix;
  args.nb = nb;
  args.zabs_ld = zabs_ld;
  args.n_chunks = n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 1: err = run<1>(args, s); break;
    case 2: err = run<2>(args, s); break;
    case 3: err = run<3>(args, s); break;
    case 4: err = run<4>(args, s); break;
    case 5: err = run<5>(args, s); break;
    case 6: err = run<6>(args, s); break;
    case 7: err = run<7>(args, s); break;
    case 8: err = run<8>(args, s); break;
    case 9: err = run<9>(args, s); break;
    case 10: err = run<10>(args, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
