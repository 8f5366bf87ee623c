// Per-step QFA loss and gradient kernels for Hopper (sm_90a), bound with
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
// Design: the C entry enqueues three kernels on the caller's stream, the
// forward and backward of epoch.cu's design without its optimizer:
//   1. forward_kernel: the per-row sums K_r = sum_p w_rp G_p, W_r =
//      sum_p u_rp F_p (G_p = F_pa F_pb, the packed triangle) and the sums
//      of ql, m and blue m, as one tiled (rows x pixels) . (pixels x
//      (NT + NH + 3)) product. A block takes kRowTile (8) batch rows and
//      kFwdSubs (4) sub-tiles of kSubPix (64) pixels, dealt out in turn to
//      the blocks of a row tile so that each gets its share of the blue
//      pixels; its plane loads are all issued at the start; per sub-tile
//      it runs each (row, pixel)'s elementwise chain once into shared
//      memory, stages the G and F rows and columns of ones once, and each
//      warp accumulates 8 rows x its lanes' columns over its 16 pixels in
//      registers. The warps' sums are added in warp order into one partial
//      per (row, column); the last block of a row tile to arrive (an
//      integer counter after __threadfence) sums the pixel tiles' partials
//      in tile order and finishes its rows: one thread per row factorizes
//      K (smallchol.cuh, reciprocal diagonal), solves and writes the NLL
//      and has-blue flag, then one thread per (row, column of K^-1) writes
//      S (packed, off-diagonal doubled) and alpha.
//   2. backward_kernel: one block per (kBwdTiles (2) tiles of kBwdPix (32)
//      pixels, chunk of kChunk (32) batch rows), one warp per group of
//      kGroupRows (8) rows. The plane loads are issued first; the chunk's
//      S and -alpha tables sit in shared memory and serve both tiles; dw
//      and du come from the tables (no Gram row in registers); each thread
//      runs its pixel's chain per row and accumulates the gradient rows
//      (dG, dF, dPsi, domega, count, dtau0, dc0, dbeta terms) in
//      registers; the groups are summed in group order; one partial per
//      (chunk, row, pixel), and the block's sums of the dtau0, dc0, dbeta
//      terms over its pixels (one shuffle tree) per (chunk, block).
//   3. finish_kernel: one thread per (accumulator row, pixel) sums the
//      chunk partials in chunk order into shared memory; one thread per F
//      element forms dF[p,a] = sum_b dG[ab] F[p,b] + dF_direct[p,a]
//      (finish_f_gradient; the doubled off-diagonal of the triangle holds
//      dG[ab] + dG[ba], the diagonal counts twice); the last block also
//      sums the rows' NLL and has-blue flags and the backward blocks'
//      scalar sums, each in one fixed order, and writes the five scalars.
//      Its inputs are complete when it starts, so no block waits for
//      another.
// The backward and the finish are launched early (programmatic dependent
// launch): each issues the loads of the call's inputs, then waits in
// pdl_wait() for the kernel before it, whose results it reads only after.
// The forward's counters are back at zero when it ends, so calls need no
// memset between them. No float atomics anywhere: every sum has a fixed
// order and which block comes last changes no bit, so two calls on the
// same inputs are bitwise equal. The TPU kernel's full nh^2 Gram in an
// (P, RC) [Gram | F | ones | blue] RHS, its (8, P) row accumulators, tiles
// of the batch and sequential grid are TPU layout with no counterpart.
//
// What bounds it on an H100: at SDSS width (Npix 1913, Nb 720, nh 8) and
// batch 500 the inputs are 13 MB (delta, error, mask, zabs) and the
// products ~0.25 GFLOP of fp32 FMAs, so a read-once floor of ~4 us on HBM
// and on the FP32 pipes alike. The design reads the planes twice (L2
// holds them between the kernels) and writes and reads ~7 MB of partials;
// the forward and the backward are latency-bound at 16 warps per SM (127
// and 128 registers), as in epoch.cu. Readings (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py phase 12 and step_variants.py; PERF.md): forward
// 23.9-24.8 us, backward 23.3-25.8, finish 4.4-4.7 per launch, each
// launched alone; 52-54 us of device time per call with the early
// launch.
// The forward's per-row finish is its 3.6-5.4 us tail (one warp per row
// instead of one thread measured 1.2-2.8 us slower), and the wrapper's
// host time before the first launch is up to a third of a call's time.
//
// Build without -use_fast_math: __expf/__logf in the tau chain and in
// log(d) miss the tolerances.

#include <cuda_runtime.h>

#include <cstddef>

#include "smallchol.cuh"
#include "train_core.cuh"

namespace {

// forward: batch rows and pixels per block (in sub-tiles staged in shared
// memory), threads; each warp takes kSubPix / kFwdWarps pixels of a
// sub-tile for all kRowTile rows
constexpr int kRowTile = 8;  // two float4 loads per multiplier array
constexpr int kSubPix = 64;
constexpr int kFwdSubs = 4;
constexpr int kFwdPix = kSubPix * kFwdSubs;
constexpr int kFwdThreads = 128;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kWarpPix = kSubPix / kFwdWarps;
// row stride of the forward's multiplier arrays: rows contiguous per
// pixel, padded to 12 floats so that a warp's (8 pixels x 4 rows) stores
// hit 32 distinct banks and each 4 rows stay 16-byte aligned
constexpr int kXRow = 12;
// one multiplier array (kSubPix pixels), padded so that the five arrays
// start in different banks
constexpr int kXStride = kSubPix * kXRow + 4;
// backward: rows per chunk (_CHUNK_ROWS), row groups (one warp each),
// pixels per block (one lane each)
constexpr int kChunk = 32;
constexpr int kGroups = 4;
constexpr int kGroupRows = kChunk / kGroups;
constexpr int kBwdPix = 32;
constexpr int kBwdTiles = 2;  // pixel tiles per block, one after another
constexpr int kBwdThreads = kBwdPix * kGroups;
// finish: pixels and threads per block
constexpr int kFinPix = 16;
constexpr int kFinThreads = 512;
constexpr int kFinWarps = kFinThreads / 32;
// grid rows (blockIdx.y) of the backward: its chunks of batch rows
constexpr int kMaxGridY = 65535;
constexpr float kLog2Pi = 1.8378770664093453f;

static_assert(kRowTile == 8, "the forward's row loads are two float4s");
static_assert(kRowTile * kSubPix == 4 * kFwdThreads,
              "four elementwise chains per thread and sub-tile");
static_assert(kBwdPix == 32 && kGroupRows == 8,
              "a backward warp: 32 pixels x two float4s of rows");

// per-row stats written by the forward's finish: NLL, has-blue flag
constexpr int kRowStat = 2;
// rows of the per-pixel accumulators after the NT + NH Gram/F rows
enum { A_PSI, A_OMEGA, A_CNT, A_T0, A_C0, A_BETA, A_EXTRA };
static_assert(A_T0 + 3 == A_EXTRA, "the scalar terms are the last three");
// the forward's multiplier arrays: w, u (for the K and W columns), then
// ql, m and blue m (for the three columns of ones)
enum { X_W, X_U, X_QL, X_M, X_MB, X_N };
// slots of the small output: loss sum, scalar count, dtau0, dc0, dbeta
enum { O_LOSS, O_SCOUNT, O_T0, O_C0, O_BETA, O_N };

template <int NH>
struct Dims {
  static constexpr int NT = qfa::ntri(NH);
  static constexpr int NV = NT + NH + 3;        // forward sums per row
  static constexpr int CPL = (NV + 31) / 32;    // forward columns per lane
  static constexpr int HS = CPL * 32 + 1;       // row stride of the H tile
  static constexpr int NR = NT + NH + A_EXTRA;  // backward accumulators
  static constexpr int NTP = (NT + 3) / 4 * 4;  // S rows, float4-aligned
  static constexpr int NHP = (NH + 3) / 4 * 4;
};

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
  float* fpart;     // (n_fwd_tiles, B, NV) forward partials
  float* partials;  // (n_chunks, NT + NH + A_EXTRA, npix)
  float* spart;     // (3, n_chunks, n_bwd) each backward block's sums of
                    // the dtau0, dc0 and dbeta terms over its pixels
  int* counters;    // (n_rtiles,) zero between launches
  float* gF;        // (npix, NH) outputs
  float* gpsi;      // (npix,)
  float* counts;    // (npix,)
  float* gomega;    // (nb,)
  float* out;       // (O_N,)
  float law_a, law_b, law_c;
  int batch_rows, npix, nb, zabs_ld, n_chunks, n_rtiles, n_bwd;
};

// Elementwise terms of one (row, pixel): the JAX kernel's forward planes.
struct Pix {
  float m, w, u, q, dinv, d_safe;
  float amp, root, exp_neg, zp1b, log_zp1, zdep;  // blue pixels only
};

// The inputs of one (row, pixel) read from the planes, loaded ahead of
// pixel_terms so that a thread's loads are in flight together: error,
// delta, the mask and, on blue pixels, zabs.
struct PixIn {
  float e, d, m, z;
};

// the mask and zabs of one (row, pixel)
__device__ __forceinline__ void load_mz(const StepArgs& a, int row, int p,
                                        PixIn& in) {
  in.m = a.mask[static_cast<size_t>(row) * a.npix + p];
  in.z = p < a.nb ? a.zabs[static_cast<size_t>(row) * a.zabs_ld + p] : 0.0f;
}

__device__ __forceinline__ PixIn load_pixel(const StepArgs& a, int row,
                                            int p) {
  const size_t off = static_cast<size_t>(row) * a.npix + p;
  PixIn in;
  in.e = a.error[off];
  in.d = a.delta[off];
  load_mz(a, row, p, in);
  return in;
}

// The JAX wrapper multiplies delta by the mask, then the mask by the row's
// weight wt (weight-0 rows are inert), and the kernel forms delta * m.
__device__ __forceinline__ Pix pixel_terms(const StepArgs& a,
                                           const PixIn& in, float wt, int p,
                                           float psi_p, float omega_p,
                                           float tau0, float c0, float beta) {
  const float e = in.e;
  Pix x;
  x.m = in.m * wt;
  const float delta_m = (in.d * in.m) * x.m;
  float d;
  if (p < a.nb) {
    const float zp1 = 1.0f + in.z;
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

// Sum N values over a block of kFinThreads threads in a fixed order
// (warp shuffles, then warp partials in warp order). Result in tot.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (&part)[kFinWarps][N],
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
    for (int w = 0; w < kFinWarps; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// First pixel of sub-tile `sub` of this forward block: the blocks of a row
// tile deal the sub-tiles out in turn (block y takes y, y + gridDim.y,
// ...), so that each gets its share of the blue pixels, whose chain costs
// the most, and none runs much longer than the others.
__device__ __forceinline__ int sub_p0(int sub) {
  return (blockIdx.y + sub * gridDim.y) * kSubPix;
}

// This thread's element of step `step` of the forward's elementwise phase
// in the sub-tile at p0: each warp takes its own kWarpPix (16) pixels for
// all 8 rows, 8 pixels x 4 rows per step. Returns its pixel and its row
// in the tile.
__device__ __forceinline__ int fwd_pixel(int p0, int step) {
  return p0 + (threadIdx.x >> 5) * kWarpPix + (step & 1) * 8 +
         (threadIdx.x & 7);
}
__device__ __forceinline__ int fwd_row(int step) {
  return (step >> 1) * 4 + ((threadIdx.x & 31) >> 3);
}

// The forward's inputs of one sub-tile for this thread beside the planes:
// the mask and zabs of its four elements, their Psi and omega, and, for
// the first kWarpPix lanes of each warp, one pixel of the warp's F rows.
template <int NH>
__device__ __forceinline__ void fwd_prefetch(
    const StepArgs& a, int r0, int nr, int p0, PixIn (&in)[4],
    float (&psi)[4], float (&omega)[4], float (&f)[NH]) {
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int p = fwd_pixel(p0, step), r = fwd_row(step);
    const bool ok = p < a.npix && r < nr;
    in[step].m = in[step].z = 0.0f;
    if (ok) load_mz(a, r0 + r, p, in[step]);
    psi[step] = ok ? a.psi[p] : 0.0f;
    omega[step] = ok && p < a.nb ? a.omega[p] : 0.0f;
  }
  const int lane = threadIdx.x & 31;
  const int p = p0 + (threadIdx.x >> 5) * kWarpPix + lane;
  const bool pin = lane < kWarpPix && p < a.npix;
#pragma unroll
  for (int i = 0; i < NH; ++i)
    f[i] = pin ? a.F[static_cast<size_t>(p) * NH + i] : 0.0f;
}

// ---- 1: forward products, then the per-row finish of each row tile -----
template <int NH>
__global__ void __launch_bounds__(kFwdThreads, 4)  // 528 blocks in one wave
    forward_kernel(StepArgs a) {
  using D = Dims<NH>;
  constexpr int NT = D::NT, NV = D::NV, CPL = D::CPL, HS = D::HS;
  // [array][pixel][row]; after the products: the warps' sums, then the
  // row tile's sums
  __shared__ __align__(16) float xs[X_N * kXStride];
  // [pixel][column]: G (packed triangle), F, ones, zero padding; after
  // the products: the row tile's Cholesky factors (packed)
  __shared__ float hs[kSubPix * HS];
  __shared__ float alpha_s[kRowTile][NH];
  __shared__ float rd_s[kRowTile][NH];  // reciprocals of L's diagonal
  __shared__ float wt_sm[kRowTile];      // the rows' weights
  __shared__ int last;
  static_assert(kFwdWarps * kRowTile * CPL * 32 + kRowTile * NV <=
                X_N * kXStride, "sums fit in xs");
  static_assert(kRowTile * NT <= kSubPix * HS, "factors fit in hs");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRowTile;  // row tiles on x, pixel tiles on y
  const int nr = min(kRowTile, a.batch_rows - r0);
  pdl_launch_dependents();
  if (tid < nr) wt_sm[tid] = a.weight[r0 + tid];

  // this lane's columns lane + 32 k and the arrays that multiply them
  int xoff[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    const int x = c < NT ? X_W : (c < NT + NH ? X_U
                                   : (c < NV ? X_QL + (c - NT - NH) : X_W));
    xoff[k] = x * kXStride;
  }
  float acc[kRowTile][CPL];
#pragma unroll
  for (int i = 0; i < kRowTile; ++i)
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[i][k] = 0.0f;
  // this thread's error and delta elements of every sub-tile at once: the
  // block's plane reads are all in flight together (the sub-tile loop
  // below stays rolled, one copy of the elementwise chain per step, so it
  // shifts these down by one sub-tile per pass)
  float e_all[kFwdSubs][4], d_all[kFwdSubs][4];
#pragma unroll
  for (int sub = 0; sub < kFwdSubs; ++sub)
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int p = fwd_pixel(sub_p0(sub), step);
      const int r = fwd_row(step);
      e_all[sub][step] = d_all[sub][step] = 0.0f;
      if (p < a.npix && r < nr) {
        const size_t off = static_cast<size_t>(r0 + r) * a.npix + p;
        e_all[sub][step] = a.error[off];
        d_all[sub][step] = a.delta[off];
      }
    }
  // the other inputs: the next sub-tile's load while this one's products
  // run
  PixIn in[4];
  float psi_in[4], omega_in[4], f[NH];
  fwd_prefetch<NH>(a, r0, nr, sub_p0(0), in, psi_in, omega_in, f);
  const float tau0 = *a.tau0;
  const float c0 = *a.c0;
  const float beta = *a.beta;
  __syncthreads();  // the rows' weights

#pragma unroll 1
  for (int sub = 0; sub < kFwdSubs; ++sub) {
    const int p0 = sub_p0(sub);
    // each warp works on its own pixels of the sub-tile: its H rows, its
    // chain elements and its products, with no barrier across warps
    if (lane < kWarpPix) {  // the warp's H rows, one lane per pixel
      const int pi = warp * kWarpPix + lane;
      const bool pin = p0 + pi < a.npix;
      float* h = hs + pi * HS;
#pragma unroll
      for (int i = 0; i < NH; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) h[qfa::tri_idx(i, j)] = f[i] * f[j];
        h[NT + i] = f[i];
      }
#pragma unroll
      for (int c = NT + NH; c < CPL * 32; ++c)
        h[c] = (c < NV && pin) ? 1.0f : 0.0f;
    }
    // the elementwise chain of the warp's (row, pixel) elements: 8 pixels
    // x 4 rows per step (32 distinct banks per store)
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int p = fwd_pixel(p0, step), r = fwd_row(step);
      const int pi = p - p0;  // pixel in the sub-tile
      in[step].e = e_all[0][step];
      in[step].d = d_all[0][step];
      float w = 0.0f, u = 0.0f, ql = 0.0f, m = 0.0f, mb = 0.0f;
      if (p < a.npix && r < nr) {
        const Pix x = pixel_terms(a, in[step], wt_sm[r], p, psi_in[step],
                                  omega_in[step], tau0, c0, beta);
        w = x.w;
        u = x.u;
        ql = x.q + x.m * logf(x.d_safe);
        m = x.m;
        mb = p < a.nb ? x.m : 0.0f;
      }
      float* o = xs + pi * kXRow + r;
      o[X_W * kXStride] = w;
      o[X_U * kXStride] = u;
      o[X_QL * kXStride] = ql;
      o[X_M * kXStride] = m;
      o[X_MB * kXStride] = mb;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k + 1 < kFwdSubs; ++k)
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        e_all[k][step] = e_all[k + 1][step];
        d_all[k][step] = d_all[k + 1][step];
      }
    if (sub + 1 < kFwdSubs)
      fwd_prefetch<NH>(a, r0, nr, sub_p0(sub + 1), in, psi_in, omega_in, f);
    // the products over this warp's pixels: kRowTile rows x CPL columns
    // per lane
#pragma unroll 4
    for (int j = 0; j < kWarpPix; ++j) {
      const int pi = warp * kWarpPix + j;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const float h = hs[pi * HS + lane + 32 * k];
        const float4* xr =
            reinterpret_cast<const float4*>(xs + xoff[k] + pi * kXRow);
        const float4 lo = xr[0], hi = xr[1];
        acc[0][k] += lo.x * h;
        acc[1][k] += lo.y * h;
        acc[2][k] += lo.z * h;
        acc[3][k] += lo.w * h;
        acc[4][k] += hi.x * h;
        acc[5][k] += hi.y * h;
        acc[6][k] += hi.z * h;
        acc[7][k] += hi.w * h;
      }
    }
    __syncwarp();  // before the next sub-tile overwrites the warp's rows
  }
  __syncthreads();  // every warp is done with xs

  // this block's partial per (row, column): the warps added in warp order
  float* wsum = xs;  // [warp][row][column slot]
#pragma unroll
  for (int i = 0; i < kRowTile; ++i)
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      wsum[(warp * kRowTile + i) * CPL * 32 + lane + 32 * k] = acc[i][k];
  __syncthreads();
  for (int k = tid; k < nr * NV; k += kFwdThreads) {
    const int r = k / NV, c = k % NV;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w) s += wsum[(w * kRowTile + r) * CPL * 32 + c];
    a.fpart[(static_cast<size_t>(blockIdx.y) * a.batch_rows + r0) * NV + k] = s;
  }
  if (!last_to_arrive(a.counters + blockIdx.x, gridDim.y, &last)) return;

  // the last block of the row tile: partials summed in pixel-tile order
  // (L2 reads: the other blocks' writes are not in this SM's L1)
  float* tot = xs + kFwdWarps * kRowTile * CPL * 32;
  const size_t stride = static_cast<size_t>(a.batch_rows) * NV;
  for (int k = tid; k < nr * NV; k += kFwdThreads) {
    const float* part = a.fpart + static_cast<size_t>(r0) * NV + k;
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < static_cast<int>(gridDim.y); ++t)
      s += __ldcg(part + t * stride);
    tot[k] = s;
  }
  __syncthreads();
  if (tid < nr) {  // one thread per row: Cholesky, solves, NLL
    const float* rt = tot + tid * NV;
    float k_tri[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) k_tri[t] = rt[t];
#pragma unroll
    for (int i = 0; i < NH; ++i) k_tri[qfa::tri_idx(i, i)] += 1.0f;
    float Lr[NH][NH], rd[NH];
    qfa::chol_rdiag<NH>(k_tri, Lr, rd);
    float wv[NH], y[NH], al[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) wv[i] = rt[NT + i];
    qfa::solve_lower_rdiag<NH>(Lr, rd, wv, y);
    qfa::solve_upper_rdiag<NH>(Lr, rd, y, al);
    float logdet = 0.0f, yy = 0.0f;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      logdet += logf(Lr[i][i]);
      yy += y[i] * y[i];
    }
    const float n_obs = rt[NT + NH + 1];
    const float n_blue = rt[NT + NH + 2];
    float* rs = a.rowstat + static_cast<size_t>(r0 + tid) * kRowStat;
    rs[0] = 0.5f * (rt[NT + NH] - yy + n_obs * kLog2Pi + 2.0f * logdet);
    // the scalar count: rows with an observed blue pixel after mask*weight
    rs[1] = n_blue > 0.5f ? 1.0f : 0.0f;
    float* Ls = hs + tid * NT;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      alpha_s[tid][i] = al[i];
      rd_s[tid][i] = rd[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) Ls[qfa::tri_idx(i, j)] = Lr[i][j];
    }
  }
  __syncthreads();
  // one thread per (row, column b of K^-1):
  // S[ab] = w_ab/2 (K^-1[ab] + al_a al_b)
  for (int k = tid; k < nr * NH; k += kFwdThreads) {
    const int r = k / NH, b = k % NH;
    const float* Ls = hs + r * NT;
    float L[NH][NH];
#pragma unroll
    for (int i = 0; i < NH; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = Ls[qfa::tri_idx(i, j)];
    float col[NH];
    qfa::kinv_column_rdiag<NH>(L, rd_s[r], b, col);
    float* s = a.S + static_cast<size_t>(r0 + r) * NT;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      if (i >= b)
        s[qfa::tri_idx(i, b)] =
            (i == b ? 0.5f : 1.0f) * (col[i] + alpha_s[r][i] * alpha_s[r][b]);
    }
    a.alpha[static_cast<size_t>(r0 + r) * NH + b] = alpha_s[r][b];
  }
}

// This thread's pixel in tile `tile` of a backward block: the blocks of a
// chunk deal the pixel tiles out in turn (block x takes x, x + gridDim.x,
// ...), so that each gets its share of the blue pixels.
__device__ __forceinline__ int bwd_pixel(int tile) {
  return (blockIdx.x + tile * gridDim.x) * kBwdPix + (threadIdx.x & 31);
}

// The plane loads of this warp's rows at pixel p (zeros past the rows and
// pixels), all issued at once.
__device__ __forceinline__ void load_rows(const StepArgs& a, int r0, int ra,
                                          int nr, int p,
                                          PixIn (&in)[kGroupRows]) {
#pragma unroll
  for (int j = 0; j < kGroupRows; ++j)
    in[j] = p < a.npix && ra + j < nr ? load_pixel(a, r0 + ra + j, p)
                                      : PixIn{0.0f, 0.0f, 0.0f, 0.0f};
}

// ---- 2: per-pixel backward over one chunk of batch rows -----------------
template <int NH>
__global__ void __launch_bounds__(kBwdThreads, 4) backward_kernel(StepArgs a) {
  using D = Dims<NH>;
  constexpr int NT = D::NT, NR = D::NR;
  constexpr int X = NT + NH;
  __shared__ __align__(16) float s_sm[kChunk][D::NTP];  // S, [row][t]
  __shared__ __align__(16) float na_sm[kChunk][D::NHP];  // -alpha
  __shared__ __align__(16) float st_sm[X][kChunk];  // [t][row]: S, -alpha
  // [t][pixel]: a tile's G then F, for dw and du; then the row groups'
  // sums, in the same memory
  constexpr int kGt = X * kBwdPix, kRed = (kGroups - 1) * NR * kBwdPix;
  __shared__ __align__(16) float tab[kGt > kRed ? kGt : kRed];
  __shared__ float wt_sm[kChunk];  // the rows' weights
  // each tile's dtau0, dc0, dbeta terms of its pixels (chunk sums)
  __shared__ float sc_sm[kBwdTiles][3][kBwdPix];
  static_assert(kChunk == kBwdPix, "one table shape for rows and pixels");
  auto gt_sm = reinterpret_cast<float (*)[kBwdPix]>(tab);
  auto red = reinterpret_cast<float (*)[NR][kBwdPix]>(tab);

  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int r0 = blockIdx.y * kChunk;
  const int nr = min(kChunk, a.batch_rows - r0);
  const int ra = grp * kGroupRows;  // this warp's rows of the chunk
  pdl_launch_dependents();
  // the call's inputs first: every row's plane loads in flight at once
  // (consumed after dw and du), the weights, the first tile's F rows,
  // Psi, omega and the scalars
  for (int k = tid; k < nr; k += kBwdThreads) wt_sm[k] = a.weight[r0 + k];
  PixIn in[kGroupRows];
  load_rows(a, r0, ra, nr, bwd_pixel(0), in);
  float f[NH], psi_p, omega_p;
  auto load_pixel_params = [&](int p) {
#pragma unroll
    for (int i = 0; i < NH; ++i)
      f[i] = p < a.npix ? a.F[static_cast<size_t>(p) * NH + i] : 0.0f;
    psi_p = p < a.npix ? a.psi[p] : 0.0f;
    omega_p = p < a.nb ? a.omega[p] : 0.0f;
  };
  load_pixel_params(bwd_pixel(0));
  const float tau0 = *a.tau0;
  const float c0 = *a.c0;
  const float beta = *a.beta;
  pdl_wait();  // S and alpha come from the forward
  // the chunk's S and alpha rows: every load in flight before the first
  // store (one round trip)
  constexpr int kSL = (kChunk * NT + kBwdThreads - 1) / kBwdThreads;
  constexpr int kAL = (kChunk * NH + kBwdThreads - 1) / kBwdThreads;
  float sv[kSL], av[kAL];  // S, -alpha
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int k = tid + j * kBwdThreads;
    sv[j] = k < nr * NT ? a.S[static_cast<size_t>(r0) * NT + k] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kAL; ++j) {
    const int k = tid + j * kBwdThreads;
    av[j] = k < nr * NH ? -a.alpha[static_cast<size_t>(r0) * NH + k] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int k = tid + j * kBwdThreads;
    if (k < kChunk * NT) {
      s_sm[k / NT][k % NT] = sv[j];
      st_sm[k % NT][k / NT] = sv[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kAL; ++j) {
    const int k = tid + j * kBwdThreads;
    if (k < kChunk * NH) {
      na_sm[k / NH][k % NH] = av[j];
      st_sm[NT + k % NH][k / NH] = av[j];
    }
  }

#pragma unroll 1
  for (int tile = 0; tile < kBwdTiles; ++tile) {
    const int p = bwd_pixel(tile);
    if (tile > 0) __syncthreads();  // the last tile's group sums are read
    // the tile's Gram and F rows, one lane per pixel, each warp a quarter
    // of the table's rows
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      if ((NT + i) % kGroups == grp) gt_sm[NT + i][lane] = f[i];
#pragma unroll
      for (int j = 0; j <= i; ++j)
        if (qfa::tri_idx(i, j) % kGroups == grp)
          gt_sm[qfa::tri_idx(i, j)][lane] = f[i] * f[j];
    }
    __syncthreads();

    // dw = S_r . G_p and du = -alpha_r . F_p for this warp's rows
    float dw[kGroupRows], du[kGroupRows];
#pragma unroll
    for (int j = 0; j < kGroupRows; ++j) dw[j] = du[j] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < NT; ++t) {
      const float gv = gt_sm[t][lane];
      const float4 lo = *reinterpret_cast<const float4*>(&st_sm[t][ra]);
      const float4 hi = *reinterpret_cast<const float4*>(&st_sm[t][ra + 4]);
      dw[0] += lo.x * gv;
      dw[1] += lo.y * gv;
      dw[2] += lo.z * gv;
      dw[3] += lo.w * gv;
      dw[4] += hi.x * gv;
      dw[5] += hi.y * gv;
      dw[6] += hi.z * gv;
      dw[7] += hi.w * gv;
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const float fo = gt_sm[NT + i][lane];
      const float4 lo = *reinterpret_cast<const float4*>(&st_sm[NT + i][ra]);
      const float4 hi =
          *reinterpret_cast<const float4*>(&st_sm[NT + i][ra + 4]);
      du[0] += lo.x * fo;
      du[1] += lo.y * fo;
      du[2] += lo.z * fo;
      du[3] += lo.w * fo;
      du[4] += hi.x * fo;
      du[5] += hi.y * fo;
      du[6] += hi.z * fo;
      du[7] += hi.w * fo;
    }

    float acc[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) acc[k] = 0.0f;
    if (p < a.npix) {
      const bool blue = p < a.nb;
#pragma unroll
      for (int j = 0; j < kGroupRows; ++j) {
        const int r = ra + j;
        if (r >= nr) break;
        const Pix x = pixel_terms(a, in[j], wt_sm[r], p, psi_p, omega_p,
                                  tau0, c0, beta);
        const float dd =
            (-(dw[j] * x.w + du[j] * x.u + 0.5f * x.q) + 0.5f * x.m) * x.dinv;
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
    }
    // the next tile's loads, in flight during this tile's sums and stores
    if (tile + 1 < kBwdTiles) {
      load_rows(a, r0, ra, nr, bwd_pixel(tile + 1), in);
      load_pixel_params(bwd_pixel(tile + 1));
    }
    // the row groups' sums, added in group order
    __syncthreads();  // every warp is done with gt_sm
    if (grp > 0) {
#pragma unroll
      for (int k = 0; k < NR; ++k) red[grp - 1][k][lane] = acc[k];
    }
    __syncthreads();
    if (grp == 0) {
      float* out =
          a.partials + static_cast<size_t>(blockIdx.y) * NR * a.npix + p;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        float s = acc[k];
#pragma unroll
        for (int q = 0; q < kGroups - 1; ++q) s += red[q][k][lane];
        if (p < a.npix) out[static_cast<size_t>(k) * a.npix] = s;
        if (k >= X + A_T0) sc_sm[tile][k - X - A_T0][lane] = s;
      }
    }
  }
  // warp 0: the block's scalar sums over its pixels (tiles in order, then
  // one fixed shuffle tree), one partial per (chunk, block)
  if (grp == 0) {
    float sc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sc[k] = 0.0f;
#pragma unroll
      for (int t = 0; t < kBwdTiles; ++t) sc[k] += sc_sm[t][k][lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sc[k] += __shfl_down_sync(0xffffffffu, sc[k], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        a.spart[(static_cast<size_t>(k) * a.n_chunks + blockIdx.y) * a.n_bwd +
                blockIdx.x] = sc[k];
    }
  }
}

// ---- 3: finished per-pixel gradients, the loss and the scalar sums -----
// Every global load of a block is issued before its first barrier, so a
// block waits for memory about once. The last block (the fewest pixels)
// also sums the rows' NLL and has-blue flags and the backward blocks'
// scalar sums, each in one fixed order: no block waits for another.
template <int NH>
__global__ void __launch_bounds__(kFinThreads) finish_kernel(StepArgs a) {
  using D = Dims<NH>;
  constexpr int NT = D::NT, NR = D::NR;
  constexpr int X = NT + NH;
  constexpr int kPairs = NR * kFinPix;  // (accumulator row, pixel) sums
  constexpr int kPairRounds = (kPairs + kFinThreads - 1) / kFinThreads;
  constexpr int kBooks = kRowStat + 3;  // NLL, scalar count, dtau0, dc0,
                                        // dbeta
  static_assert(kFinPix * NH <= kFinThreads, "one thread per F element");
  __shared__ float sacc[NR][kFinPix];
  __shared__ float f_sm[kFinPix][NH];
  __shared__ float part[kFinWarps][kBooks];
  __shared__ float books[kBooks];

  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * kFinPix;
  const bool keeps_books = blockIdx.x + 1 == gridDim.x;
  pdl_launch_dependents();
  // the call's inputs first: this thread's F element (pl, i) and tau0
  const int fpl = tid / NH, fi = tid % NH, fp = p0 + fpl;
  const bool has_f = tid < kFinPix * NH && fp < a.npix;
  const size_t fe = static_cast<size_t>(fp) * NH + fi;
  const float f_el = has_f ? a.F[fe] : 0.0f;
  const float tau0 = *a.tau0;
  pdl_wait();  // every other input comes from the forward and backward
  // chunk partials summed in chunk order, one thread per (row, pixel)
  float sums[kPairRounds];
#pragma unroll
  for (int j = 0; j < kPairRounds; ++j) {
    const int k = tid + j * kFinThreads;
    const int p = p0 + k % kFinPix;
    float s = 0.0f;
    if (k < kPairs && p < a.npix) {
      const float* in = a.partials + static_cast<size_t>(k / kFinPix) * a.npix + p;
      const size_t stride = static_cast<size_t>(NR) * a.npix;
#pragma unroll 16
      for (int c = 0; c < a.n_chunks; ++c) s += in[c * stride];
    }
    sums[j] = s;
  }
  // the last block: the rows' stats and the backward blocks' scalar sums
  float v[kBooks] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (keeps_books) {
    for (int r = tid; r < a.batch_rows; r += kFinThreads) {
#pragma unroll
      for (int k = 0; k < kRowStat; ++k)
        v[k] += a.rowstat[static_cast<size_t>(r) * kRowStat + k];
    }
    const int n_sp = a.n_chunks * a.n_bwd;
    for (int b = tid; b < n_sp; b += kFinThreads) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[kRowStat + k] += a.spart[static_cast<size_t>(k) * n_sp + b];
    }
  }
#pragma unroll
  for (int j = 0; j < kPairRounds; ++j) {
    const int k = tid + j * kFinThreads;
    if (k < kPairs) sacc[k / kFinPix][k % kFinPix] = sums[j];
  }
  if (tid < kFinPix * NH) f_sm[fpl][fi] = f_el;
  __syncthreads();

  if (has_f) {
    // dF[i] = dRHS_F[i] + sum_j dG[ij] F[j] (the diagonal triangle entry
    // counts twice, the off-diagonal ones hold dG[ij] + dG[ji])
    float df = sacc[NT + fi][fpl];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float dg = sacc[qfa::tri_idx(fi, j)][fpl];
      if (fi == j) dg = dg + dg;
      df = df + dg * f_sm[fpl][j];
    }
    a.gF[fe] = df;
  }
  // Psi and the count (warp 0), omega (warp 1) of one pixel each
  const int role = tid >> 5, p = p0 + lane;
  const bool pin = lane < kFinPix && p < a.npix;
  if (role == 0 && pin) {
    a.gpsi[p] = sacc[X + A_PSI][lane];
    a.counts[p] = sacc[X + A_CNT][lane];
  } else if (role == 1 && pin && p < a.nb) {
    a.gomega[p] = sacc[X + A_OMEGA][lane];
  }
  if (!keeps_books) return;
  block_sum<kBooks>(v, part, books);
  if (tid == 0) {
    a.out[O_LOSS] = books[0];
    a.out[O_SCOUNT] = books[1];
    a.out[O_T0] = books[kRowStat];
    a.out[O_C0] = -books[kRowStat + 1];
    a.out[O_BETA] = tau0 * books[kRowStat + 2];
  }
}

// forward blocks per row tile, backward blocks per chunk, finish blocks
int fwd_tiles(int npix) { return (npix + kFwdPix - 1) / kFwdPix; }
int bwd_blocks(int npix) {
  return (npix + kBwdPix * kBwdTiles - 1) / (kBwdPix * kBwdTiles);
}
int fin_blocks(int npix) { return (npix + kFinPix - 1) / kFinPix; }

// The call's three kernels; with `early`, the backward and the finish are
// launched early. The forward follows the caller's kernels and copies in
// plain stream order.
template <int NH>
cudaError_t run(const StepArgs& args, bool early, cudaStream_t s) {
  const dim3 fwd_grid(args.n_rtiles, fwd_tiles(args.npix));
  const dim3 bwd_grid(args.n_bwd, args.n_chunks);
  cudaError_t err =
      launch(forward_kernel<NH>, fwd_grid, kFwdThreads, s, false, args);
  if (err == cudaSuccess)
    err = launch(backward_kernel<NH>, bwd_grid, kBwdThreads, s, early, args);
  if (err == cudaSuccess)
    err = launch(finish_kernel<NH>, dim3(fin_blocks(args.npix)), kFinThreads,
                 s, early, args);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

cudaError_t run_nh(int nh, const StepArgs& args, bool early, cudaStream_t s) {
  switch (nh) {
    case 1: return run<1>(args, early, s);
    case 2: return run<2>(args, early, s);
    case 3: return run<3>(args, early, s);
    case 4: return run<4>(args, early, s);
    case 5: return run<5>(args, early, s);
    case 6: return run<6>(args, early, s);
    case 7: return run<7>(args, early, s);
    case 8: return run<8>(args, early, s);
    case 9: return run<9>(args, early, s);
    case 10: return run<10>(args, early, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of the scratch buffer for these shapes: S, alpha, the row stats,
// the forward and backward partials and the backward blocks' scalar sums.
long long qfa_step_scratch_len(int batch_rows, int npix, int nh) {
  const long long b = batch_rows, nt = nh * (nh + 1) / 2;
  const long long n_chunks = (batch_rows + kChunk - 1) / kChunk;
  return b * (nt + nh + kRowStat) + fwd_tiles(npix) * b * (nt + nh + 3) +
         n_chunks * ((nt + nh + A_EXTRA) * npix + 3LL * bwd_blocks(npix));
}

// Arrival counters for these shapes: one per forward row tile.
int qfa_step_n_counters(int batch_rows) {
  return (batch_rows + kRowTile - 1) / kRowTile;
}

// Loss and summed gradients of one batch of batch_rows rows on `stream` of
// `device`. Every pointer is device memory: the batch planes, the
// parameters (tau0, c0, beta as device scalars), the scratch
// (qfa_step_scratch_len floats), the counters (qfa_step_n_counters ints,
// zero on entry and again on exit) and the output, one buffer of
// [gF (npix, nh) | gpsi (npix) | counts (npix) | gomega (nb) | loss sum,
// scalar count, dtau0, dc0, dbeta]. With early = 0 each kernel starts
// when the one before it has ended (for timing each one alone). Returns
// the first error that is not cudaSuccess (0 = every kernel launched);
// nothing is synchronised. nh must be 1..10.
int qfa_step_f32(
    const float* delta, const float* error, const float* zabs, int zabs_ld,
    const float* mask, const float* weight, const float* F, const float* psi,
    const float* omega, const float* tau0, const float* c0, const float* beta,
    float law_a, float law_b, float law_c, int batch_rows, int npix, int nb,
    int nh, float* scratch, long long scratch_len, int* counters,
    int n_counters, float* out, int early, int device, void* stream) {
  const int n_rtiles = (batch_rows + kRowTile - 1) / kRowTile;
  if (batch_rows <= 0 || npix <= 0 || nb < 0 || nb > npix || zabs_ld < nb ||
      nh < 1 || (batch_rows + kChunk - 1) / kChunk > kMaxGridY ||
      scratch_len < qfa_step_scratch_len(batch_rows, npix, nh) ||
      n_counters < qfa_step_n_counters(batch_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long b = batch_rows, nt = nh * (nh + 1) / 2;
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
  args.batch_rows = batch_rows;
  args.npix = npix;
  args.nb = nb;
  args.zabs_ld = zabs_ld;
  args.n_chunks = (batch_rows + kChunk - 1) / kChunk;
  args.n_rtiles = n_rtiles;
  args.n_bwd = bwd_blocks(npix);
  args.S = scratch;
  args.alpha = args.S + b * nt;
  args.rowstat = args.alpha + b * nh;
  args.fpart = args.rowstat + b * kRowStat;
  args.partials = args.fpart + fwd_tiles(npix) * b * (nt + nh + 3);
  args.spart = args.partials +
               static_cast<long long>(args.n_chunks) * (nt + nh + A_EXTRA) *
                   npix;
  args.counters = counters;
  args.gF = out;
  args.gpsi = out + static_cast<long long>(npix) * nh;
  args.counts = args.gpsi + npix;
  args.gomega = args.counts + npix;
  args.out = args.gomega + nb;
  args.law_a = law_a;
  args.law_b = law_b;
  args.law_c = law_c;
  // launch on `device`, and leave the thread's current device as it was
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = run_nh(nh, args, early != 0, static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
