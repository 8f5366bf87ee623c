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
// Design: the host loop below enqueues three kernels per batch on the
// caller's stream; state (params, moments, scalars) lives in device
// buffers the wrapper owns and is updated in place between batches.
//   1. forward_kernel: the per-row sums K_r = sum_p w_rp G_p, W_r =
//      sum_p u_rp F_p (with G_p = F_pa F_pb, the packed triangle) and the
//      sums of ql, m and blue m, as one tiled (rows x pixels) . (pixels x
//      (NT + NH + 3)) product. A block takes kRowTile (8) batch rows and
//      kFwdSubs (4) sub-tiles of kSubPix (64) pixels, dealt out in turn
//      to the blocks of a row tile so that each gets its share of the
//      blue pixels (whose chain costs the most): its plane loads
//      are all issued at the start; per sub-tile it runs each (row,
//      pixel)'s elementwise chain once into shared memory, stages the G
//      and F rows (bf16-rounded under mxu_bf16) and columns of ones once,
//      and each warp accumulates the 8 rows x its lanes' columns over its
//      16 pixels in registers (two float4 loads of rows per column). The
//      warps' sums are added in warp order into one partial per (row,
//      column); the last block of a row tile to finish (an integer
//      counter after __threadfence) sums the pixel tiles' partials in
//      tile order and finishes its rows: one thread per row factorizes K
//      (smallchol.cuh, reciprocal diagonal), solves, writes the NLL,
//      has-blue flag and weight, then one thread per (row, column of
//      K^-1) writes S and alpha.
//   2. backward_kernel: one block per (kBwdTiles tiles of kBwdPix pixels,
//      chunk of kChunk batch rows), one warp per group of kGroupRows rows
//      of the chunk; the chunk's S and alpha tables are loaded once and
//      serve both tiles, so the grid is one wave. The plane loads of a
//      thread's 8 rows are issued first (the next tile's during this
//      tile's sums); dw = S_r . G_p and du = -alpha_r . F_p come from
//      tables in shared memory (8 rows per float4 pair), so no Gram row
//      sits in registers; then each thread runs its pixel's elementwise
//      chain per row and accumulates the gradient rows in registers; the
//      groups are summed in shared memory in group order; one partial per
//      (chunk, row, pixel).
//   3. update_kernel: one thread per (accumulator row, pixel) sums the
//      chunk partials in chunk order, every block sums the batch's loss
//      books in one fixed order (block 0 records them), all its global
//      loads issued before its first barrier; one thread per F element
//      (Psi, omega: per pixel) runs Adam and the clip, and each block sums
//      its pixels' dtau0/dc0/dbeta terms. Adam and the clip of tau0, c0,
//      beta over those block sums (scalar_step) run at the start of the
//      next batch's forward, in every block alike, so no block of the
//      update waits for the others; after the call's last batch, the
//      update's last block to finish (integer counter) runs them.
// No float atomics anywhere: every sum has a fixed order, and which block
// comes last changes no bit, so k epochs in one call are bitwise equal to
// k chained calls. The TPU kernel's (rc, P) [tri(Gram) | F | ones]
// scratch, lane-major stats, 128-lane blue split and single (epoch, batch,
// tile) grid are TPU layout with no counterpart.
//
// Planes: delta and error are float32 or bfloat16 (a uniform run-time
// flag), converted to float32 at load as the JAX kernel does; everything
// else is float32. mxu_bf16 rounds the operands of the six heavy products
// (K triangle, W, dw, du, dG, dF; the JAX kernel's dot_big) to bfloat16
// with __float2bfloat16_rn and accumulates in fp32 (a product of two bf16
// values is exact in fp32); the sums of ql, the counts and the Cholesky
// chain stay fp32.
//
// What bounds it on an H100: per batch row and pixel, the forward and the
// backward each read delta and error (8 or 4 bytes) and run the exp chain
// on blue pixels plus ~ntri + nh FMAs (forward) and ~2 (ntri + nh) FMAs
// (backward); at SDSS width (Npix 1913, nh 8) an epoch over 65,536
// spectra reads ~1 GB and does ~33 GFLOP of fp32 products, so the bound
// is the FP32 pipes (~0.49 ms). What kept the first design at 24x that
// bound was occupancy, serial tails and five launches per batch: this
// design keeps the forward's products in register tiles fed from shared
// memory, runs the backward with four times the threads, spreads the
// update over (row, pixel) threads, and launches three kernels per batch.
// It still takes ~20x the bound: each kernel is latency-bound at 16 warps
// per SM, and each launch leaves the card idle for ~4 us (PERF.md).
// Tensor cores and CUDA graphs are later work.
//
// Build without -use_fast_math: __expf/__logf in the tau chain and in
// log(d) miss the tolerances.

#include <cuda_bf16.h>
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
// update: pixels and threads per block
constexpr int kUpdPix = 16;
constexpr int kUpdThreads = 512;
constexpr int kUpdWarps = kUpdThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;

static_assert(kRowTile == 8, "the forward's row loads are two float4s");
static_assert(kRowTile * kSubPix == 4 * kFwdThreads,
              "four elementwise chains per thread and sub-tile");
static_assert(kBwdPix == 32 && kGroupRows == 8,
              "a backward warp: 32 pixels x two float4s of rows");

// slots of the host hyper-parameter array (ops/epoch_kernel.py, _launch)
enum {
  HP_LAW_A, HP_LAW_B, HP_LAW_C, HP_EPS, HP_WD, HP_B1, HP_B2, HP_VMIN,
  HP_VMAX, HP_T0MIN, HP_T0MAX, HP_BMIN, HP_BMAX, HP_CMIN, HP_CMAX,
  HP_REFNORM
};
// slots of the device scalar state: value, m, v of tau0, c0, beta
enum { S_T0, S_C0, S_BETA, S_MT0, S_MC0, S_MBETA, S_VT0, S_VC0, S_VBETA };
// per-row stats written by the forward's finish: NLL, has-blue, weight
constexpr int kRowStat = 3;
// rows of the per-pixel accumulators after the NT + NH Gram/F rows
enum { A_PSI, A_OMEGA, A_CNT, A_T0, A_C0, A_BETA, A_EXTRA };
// the forward's multiplier arrays: w, u (for the K and W columns), then
// ql, m and blue m (for the three columns of ones)
enum { X_W, X_U, X_QL, X_M, X_MB, X_N };

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

struct EpochArgs {
  const void* delta;    // (N, npix) float, or bfloat16 with planes_bf16
  const void* error;    // (N, npix), same type; 0 where masked when derive_mask
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
  float* scal;      // (2, 9): batch g of the call runs with slot g % 2
                    // (S_* order); the forward writes it (scalar_step)
  float* S;         // (B, NT) packed S triangle, off-diagonal doubled
  float* alpha;     // (B, NH)
  float* rowstat;   // (B, kRowStat)
  float* fpart;     // (n_fwd_tiles, B, NV) forward partials
  float* partials;  // (n_chunks, NT + NH + A_EXTRA, npix)
  float* spart;     // (3, n_upd_pad) each update block's dtau0, dc0,
                    // dbeta sums; zero past the update's blocks
  float* books;     // (3,) the batch's summed rowstat
  int* counters;    // (n_rtiles + 1,) zero between launches
  float* loss_out;  // (n_epochs * n_batches,)
  float* nreal_out;
  float law_a, law_b, law_c, eps, wd, b1, b2;
  float vmin, vmax, t0min, t0max, bmin, bmax, cmin, cmax;
  int refnorm, mxu_bf16, planes_bf16;
  int npix, nb, zabs_ld, derive_mask, derive_zabs;
  int tile_batch, batch_rows, n_chunks, n_rtiles;
  int n_upd_pad;  // update blocks, rounded up to a multiple of 4
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

// Adam with weight decay: updates the moments, returns the new parameter
__device__ __forceinline__ float adam(const EpochArgs& a, float prm,
                                     float grad, float& mo, float& ve,
                                     float lr, float bc1, float bc2) {
  const float gg = grad + a.wd * prm;
  mo = (1.0f - a.b1) * gg + a.b1 * mo;
  ve = (1.0f - a.b2) * gg * gg + a.b2 * ve;
  return prm - lr * (mo / bc1) / (sqrtf(ve / bc2) + a.eps);
}

// The Adam step and clip of tau0, c0 and beta at the end of a batch, from
// the state `in` it ran with to `out` (S_* order): their gradients are the
// update blocks' sums, normalized by the batch's books. It runs at the
// start of the next batch's forward (once per block) or at the end of the
// call's last update, and gives the same bits in both: each lane adds its
// float4s of the block sums in order, the lanes' sums meet in a fixed
// shuffle tree, lane 0's result goes to every lane, and each product and
// sum is rounded on its own (no contraction into FMAs). A few wide loads
// per warp: every block of a launch reads these same lines. Called by one
// whole warp.
__device__ __forceinline__ void scalar_step(const EpochArgs& a,
                                            const float* in, float lr,
                                            float bc1, float bc2,
                                            float (&out)[9]) {
  const int lane = threadIdx.x & 31;
  // lanes 0-8: the state; lanes 9-11: the books
  const float st = lane < 9 ? __ldcg(in + lane)
                            : (lane < 12 ? __ldcg(a.books + lane - 9) : 0.0f);
  float g[3] = {0.0f, 0.0f, 0.0f};
  for (int b = 4 * lane; b < a.n_upd_pad; b += 128) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 v = __ldcg(
          reinterpret_cast<const float4*>(a.spart + k * a.n_upd_pad + b));
      g[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(g[k], v.x), v.y), v.z),
                       v.w);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      g[k] = __fadd_rn(g[k], __shfl_down_sync(0xffffffffu, g[k], o));
    g[k] = __shfl_sync(0xffffffffu, g[k], 0);
  }
  float s[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) s[k] = __shfl_sync(0xffffffffu, st, k);
  const float n_real = fmaxf(__shfl_sync(0xffffffffu, st, 11), 1.0f);
  const float sdenom =
      a.refnorm ? fmaxf(__shfl_sync(0xffffffffu, st, 10), 1.0f) : n_real;
  const float lo[3] = {a.t0min, a.cmin, a.bmin};
  const float hi[3] = {a.t0max, a.cmax, a.bmax};
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // tau0, c0, beta: adam() without FMAs
    const float prm = s[S_T0 + k];
    const float gg = __fadd_rn(__fdiv_rn(g[k], sdenom), __fmul_rn(a.wd, prm));
    const float mo = __fadd_rn(__fmul_rn(1.0f - a.b1, gg),
                               __fmul_rn(a.b1, s[S_MT0 + k]));
    const float ve = __fadd_rn(__fmul_rn(__fmul_rn(1.0f - a.b2, gg), gg),
                               __fmul_rn(a.b2, s[S_VT0 + k]));
    const float step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mo, bc1)),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(ve, bc2)),
                                           a.eps));
    out[S_T0 + k] = clip(__fsub_rn(prm, step), lo[k], hi[k]);
    out[S_MT0 + k] = mo;
    out[S_VT0 + k] = ve;
  }
}

// a delta or error element as float32
__device__ __forceinline__ float load_plane(const EpochArgs& a, const void* p,
                                            size_t i) {
  return a.planes_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
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

// The inputs of one (row, pixel) read from the planes, loaded ahead of
// pixel_terms so that a thread's loads are in flight together: error,
// delta, the mask (plane layout) and, on blue pixels, log(1 + zabs)
// (derived layout) or zabs (plane layout).
struct PixIn {
  float e, d, m, z;
};

// the mask and z of one (row, pixel)
__device__ __forceinline__ void load_mz(const EpochArgs& a, size_t row, int p,
                                        PixIn& in) {
  in.m = a.derive_mask ? 0.0f : a.mask[row * a.npix + p];
  const float* zrow = a.zabs + row * a.zabs_ld;
  // log(1 + zabs) = log1p(zqso) + log(lam / lam_lya)
  in.z = p >= a.nb ? 0.0f
                   : (a.derive_zabs ? zrow[0] + a.loglam[p] : zrow[p]);
}

__device__ __forceinline__ PixIn load_pixel(const EpochArgs& a, size_t row,
                                            int p) {
  const size_t off = row * a.npix + p;
  PixIn in;
  in.e = load_plane(a, a.error, off);
  in.d = load_plane(a, a.delta, off);
  load_mz(a, row, p, in);
  return in;
}

__device__ __forceinline__ Pix pixel_terms(const EpochArgs& a,
                                           const PixIn& in, int p,
                                           float psi_p, float omega_p,
                                           float tau0, float c0, float beta) {
  const float e = in.e;
  Pix x;
  x.m = a.derive_mask ? (e > 0.0f ? 1.0f : 0.0f) : in.m;
  const float delta_m = in.d * x.m;
  float d;
  if (p < a.nb) {
    float tau_line;
    if (a.derive_zabs) {
      const float lz = in.z;
      tau_line = a.law_a * expf(a.law_b * lz) + a.law_c;
      x.zp1b = expf(beta * lz);
      x.log_zp1 = lz;
    } else {
      const float zp1 = 1.0f + in.z;
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

// Sum N values over a block of kUpdThreads threads in a fixed order
// (warp shuffles, then warp partials in warp order). Result in tot.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (&part)[kUpdWarps][N],
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
    for (int w = 0; w < kUpdWarps; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// First pixel of sub-tile `sub` of this forward block: the blocks of a row
// tile deal the sub-tiles out in turn (block x takes x, x + gridDim.x,
// ...), so that each gets its share of the blue pixels, whose chain costs
// the most, and none runs much longer than the others.
__device__ __forceinline__ int sub_p0(int sub) {
  return (blockIdx.x + sub * gridDim.x) * kSubPix;
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
// the mask and z of its four elements, their Psi and omega, and, for the
// first kWarpPix lanes of each warp, one pixel of the warp's F rows.
template <int NH>
__device__ __forceinline__ void fwd_prefetch(
    const EpochArgs& a, const size_t* row_sm, int nr, int p0, PixIn (&in)[4],
    float (&psi)[4], float (&omega)[4], float (&f)[NH]) {
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int p = fwd_pixel(p0, step), r = fwd_row(step);
    const bool ok = p < a.npix && r < nr;
    in[step].m = in[step].z = 0.0f;
    if (ok) load_mz(a, row_sm[r], p, in[step]);
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
// Batch g of the call, its rows from tile `base` of the permutation; lr,
// bc1 and bc2 are the schedule of batch g - 1.
template <int NH>
__global__ void __launch_bounds__(kFwdThreads, 4)  // 528 blocks in one wave
    forward_kernel(EpochArgs a, int base, int g, float lr, float bc1,
                   float bc2) {
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
  __shared__ size_t row_sm[kRowTile];
  __shared__ float scal_sm[3];  // tau0, c0, beta of this batch
  __shared__ int last;
  static_assert(kFwdWarps * kRowTile * CPL * 32 + kRowTile * NV <=
                X_N * kXStride, "sums fit in xs");
  static_assert(kRowTile * NT <= kSubPix * HS, "factors fit in hs");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, a.batch_rows - r0);
  pdl_launch_dependents();
  if (tid < nr) row_sm[tid] = batch_row(a, base, r0 + tid);
  const int mxu = a.mxu_bf16;

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
  __syncthreads();
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
        const size_t off = row_sm[r] * a.npix + p;
        e_all[sub][step] = load_plane(a, a.error, off);
        d_all[sub][step] = load_plane(a, a.delta, off);
      }
    }
  pdl_wait();  // the parameters come from the previous batch's update
  // the other inputs: the next sub-tile's load while this one's products
  // run
  PixIn in[4];
  float psi_in[4], omega_in[4], f[NH];
  fwd_prefetch<NH>(a, row_sm, nr, sub_p0(0), in, psi_in, omega_in,
                   f);
  // the previous batch's step of tau0, c0, beta, by warp 0 (block 0 keeps
  // it)
  if (warp == 0) {
    float s[9];
    float* cur = a.scal + 9 * (g & 1);
    if (g > 0) {
      scalar_step(a, a.scal + 9 * ((g - 1) & 1), lr, bc1, bc2, s);
      if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) cur[k] = s[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) s[k] = cur[k];
    }
    if (lane < 3) scal_sm[lane] = s[lane];
  }
  __syncthreads();  // this batch's tau0, c0, beta
  const float tau0 = scal_sm[S_T0];
  const float c0 = scal_sm[S_C0];
  const float beta = scal_sm[S_BETA];

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
        for (int j = 0; j <= i; ++j) h[qfa::tri_idx(i, j)] = opnd(f[i] * f[j], mxu);
        h[NT + i] = opnd(f[i], mxu);
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
        const Pix x = pixel_terms(a, in[step], p, psi_in[step],
                                  omega_in[step], tau0, c0, beta);
        w = opnd(x.w, mxu);
        u = opnd(x.u, mxu);
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
      fwd_prefetch<NH>(a, row_sm, nr, sub_p0(sub + 1), in, psi_in, omega_in,
                       f);
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
    a.fpart[(static_cast<size_t>(blockIdx.x) * a.batch_rows + r0) * NV + k] = s;
  }
  if (!last_to_arrive(a.counters + blockIdx.y, gridDim.x, &last)) return;

  // the last block of the row tile: partials summed in pixel-tile order
  // (L2 reads: the other blocks' writes are not in this SM's L1)
  float* tot = xs + kFwdWarps * kRowTile * CPL * 32;
  const size_t stride = static_cast<size_t>(a.batch_rows) * NV;
  for (int k = tid; k < nr * NV; k += kFwdThreads) {
    const float* part = a.fpart + static_cast<size_t>(r0) * NV + k;
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < static_cast<int>(gridDim.x); ++t)
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
    rs[1] = n_blue > 0.5f ? 1.0f : 0.0f;
    // n_real: the zq column's weight in the derived layout, rows with an
    // observed pixel in the plane layout
    rs[2] = a.derive_zabs ? a.zabs[row_sm[tid] * a.zabs_ld + 1]
                          : (n_obs > 0.5f ? 1.0f : 0.0f);
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
__device__ __forceinline__ void load_rows(const EpochArgs& a,
                                          const size_t* row_sm, int ra,
                                          int nr, int p,
                                          PixIn (&in)[kGroupRows]) {
#pragma unroll
  for (int j = 0; j < kGroupRows; ++j)
    in[j] = p < a.npix && ra + j < nr ? load_pixel(a, row_sm[ra + j], p)
                                      : PixIn{0.0f, 0.0f, 0.0f, 0.0f};
}

// ---- 2: per-pixel backward over one chunk of batch rows -----------------
template <int NH>
__global__ void __launch_bounds__(kBwdThreads, 4)
    backward_kernel(EpochArgs a, int base, int g) {
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
  __shared__ size_t row_sm[kChunk];
  static_assert(kChunk == kBwdPix, "one table shape for rows and pixels");
  auto gt_sm = reinterpret_cast<float (*)[kBwdPix]>(tab);
  auto red = reinterpret_cast<float (*)[NR][kBwdPix]>(tab);

  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int mxu = a.mxu_bf16;
  const int r0 = blockIdx.y * kChunk;
  const int nr = min(kChunk, a.batch_rows - r0);
  const int ra = grp * kGroupRows;  // this warp's rows of the chunk
  pdl_launch_dependents();
  for (int k = tid; k < nr; k += kBwdThreads)
    row_sm[k] = batch_row(a, base, r0 + k);
  __syncthreads();
  // every row's plane loads in flight at once, consumed after dw and du
  PixIn in[kGroupRows];
  load_rows(a, row_sm, ra, nr, bwd_pixel(0), in);
  pdl_wait();  // S and alpha come from this batch's forward
  // the chunk's S and alpha rows and the first tile's F rows, Psi and
  // omega: every load in flight before the first store (one round trip)
  constexpr int kSL = (kChunk * NT + kBwdThreads - 1) / kBwdThreads;
  constexpr int kAL = (kChunk * NH + kBwdThreads - 1) / kBwdThreads;
  float sv[kSL], av[kAL], f[NH], psi_p, omega_p;  // S, -alpha, F, Psi, omega
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
  auto load_pixel_params = [&](int p) {
#pragma unroll
    for (int i = 0; i < NH; ++i)
      f[i] = p < a.npix ? a.F[static_cast<size_t>(p) * NH + i] : 0.0f;
    psi_p = p < a.npix ? a.psi[p] : 0.0f;
    omega_p = p < a.nb ? a.omega[p] : 0.0f;
  };
  load_pixel_params(bwd_pixel(0));
  const float* sc = a.scal + 9 * (g & 1);
  const float tau0 = sc[S_T0];
  const float c0 = sc[S_C0];
  const float beta = sc[S_BETA];
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int k = tid + j * kBwdThreads;
    if (k < kChunk * NT) {
      const float v = opnd(sv[j], mxu);
      s_sm[k / NT][k % NT] = v;
      st_sm[k % NT][k / NT] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < kAL; ++j) {
    const int k = tid + j * kBwdThreads;
    if (k < kChunk * NH) {
      const float v = opnd(av[j], mxu);
      na_sm[k / NH][k % NH] = v;
      st_sm[NT + k % NH][k / NH] = v;
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
      if ((NT + i) % kGroups == grp) gt_sm[NT + i][lane] = opnd(f[i], mxu);
#pragma unroll
      for (int j = 0; j <= i; ++j)
        if (qfa::tri_idx(i, j) % kGroups == grp)
          gt_sm[qfa::tri_idx(i, j)][lane] = opnd(f[i] * f[j], mxu);
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
        const Pix x =
            pixel_terms(a, in[j], p, psi_p, omega_p, tau0, c0, beta);
        const float dd =
            (-(dw[j] * x.w + du[j] * x.u + 0.5f * x.q) + 0.5f * x.m) * x.dinv;
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
    }
    // the next tile's loads, in flight during this tile's sums and stores
    if (tile + 1 < kBwdTiles) {
      load_rows(a, row_sm, ra, nr, bwd_pixel(tile + 1), in);
      load_pixel_params(bwd_pixel(tile + 1));
    }
    // the row groups' sums, added in group order
    __syncthreads();  // every warp is done with gt_sm
    if (grp > 0) {
#pragma unroll
      for (int k = 0; k < NR; ++k) red[grp - 1][k][lane] = acc[k];
    }
    __syncthreads();
    if (grp == 0 && p < a.npix) {
      float* out =
          a.partials + static_cast<size_t>(blockIdx.y) * NR * a.npix + p;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        float s = acc[k];
#pragma unroll
        for (int q = 0; q < kGroups - 1; ++q) s += red[q][k][lane];
        out[static_cast<size_t>(k) * a.npix] = s;
      }
    }
  }
}

// ---- 3: books, Adam and clip of F, Psi, omega; the scalars' gradients --
// Every global load of a block is issued before its first barrier, so a
// block waits for memory about once.
template <int NH>
__global__ void __launch_bounds__(kUpdThreads)
    update_kernel(EpochArgs a, int out_idx, float lr, float bc1, float bc2,
                  int last_batch) {
  using D = Dims<NH>;
  constexpr int NT = D::NT, NR = D::NR;
  constexpr int X = NT + NH;
  constexpr int kPairs = NR * kUpdPix;  // (accumulator row, pixel) sums
  constexpr int kPairRounds = (kPairs + kUpdThreads - 1) / kUpdThreads;
  static_assert(kUpdPix * NH <= kUpdThreads, "one thread per F element");
  __shared__ float sacc[NR][kUpdPix];
  __shared__ float f_sm[kUpdPix][NH];  // F before this update
  __shared__ float part[kUpdWarps][kRowStat];
  __shared__ float books[kRowStat];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kUpdPix;
  pdl_launch_dependents();
  pdl_wait();  // every input comes from this batch's forward and backward
  // chunk partials summed in chunk order, one thread per (row, pixel)
  float sums[kPairRounds];
#pragma unroll
  for (int j = 0; j < kPairRounds; ++j) {
    const int k = tid + j * kUpdThreads;
    const int p = p0 + k % kUpdPix;
    float s = 0.0f;
    if (k < kPairs && p < a.npix) {
      const float* in = a.partials + static_cast<size_t>(k / kUpdPix) * a.npix + p;
      const size_t stride = static_cast<size_t>(NR) * a.npix;
#pragma unroll 16
      for (int c = 0; c < a.n_chunks; ++c) s += in[c * stride];
    }
    sums[j] = s;
  }
  // the batch's loss books, in one fixed order in every block
  float v[kRowStat] = {0.0f, 0.0f, 0.0f};
  for (int r = tid; r < a.batch_rows; r += kUpdThreads) {
#pragma unroll
    for (int k = 0; k < kRowStat; ++k)
      v[k] += a.rowstat[static_cast<size_t>(r) * kRowStat + k];
  }
  // this thread's parameter and moments: F element (pl, i) ...
  const int fpl = tid / NH, fi = tid % NH, fp = p0 + fpl;
  const bool has_f = tid < kUpdPix * NH && fp < a.npix;
  const size_t fe = static_cast<size_t>(fp) * NH + fi;
  float f_old = 0.0f, f_m = 0.0f, f_v = 0.0f;
  if (has_f) {
    f_old = a.F[fe];
    f_m = a.mF[fe];
    f_v = a.vF[fe];
  }
  // ... or Psi (warp 0) or omega (warp 1) of one pixel, or its scalar
  // rows (warp 2)
  const int role = tid >> 5, pl = tid & 31, p = p0 + pl;
  const bool has_psi = role == 0 && pl < kUpdPix && p < a.npix;
  const bool has_omega = role == 1 && pl < kUpdPix && p < a.nb;
  const bool has_srow = role == 2 && pl < kUpdPix && p < a.nb;
  float x_old = 0.0f, x_m = 0.0f, x_v = 0.0f;
  if (has_psi) {
    x_old = a.psi[p];
    x_m = a.mpsi[p];
    x_v = a.vpsi[p];
  } else if (has_omega) {
    x_old = a.omega[p];
    x_m = a.momega[p];
    x_v = a.vomega[p];
  }
  const float tau0 = a.scal[9 * (out_idx & 1) + S_T0];
#pragma unroll
  for (int j = 0; j < kPairRounds; ++j) {
    const int k = tid + j * kUpdThreads;
    if (k < kPairs) sacc[k / kUpdPix][k % kUpdPix] = sums[j];
  }
  if (tid < kUpdPix * NH) f_sm[fpl][fi] = f_old;
  block_sum<kRowStat>(v, part, books);  // its barriers publish sacc, f_sm
  if (blockIdx.x == 0 && tid == 0) {
    a.loss_out[out_idx] = books[0];   // summed NLL
    a.nreal_out[out_idx] = books[2];  // n_real
#pragma unroll
    for (int k = 0; k < kRowStat; ++k) a.books[k] = books[k];
  }

  const float n_real = fmaxf(books[2], 1.0f);
  // count normalization of pixel pl: (denominator, 0 for never observed)
  auto norm = [&](int pl, float& denom, float& zero) {
    const float cnt = sacc[X + A_CNT][pl];
    if (a.refnorm) {
      denom = fmaxf(cnt, 1.0f);
      zero = cnt > 0.0f ? 1.0f : 0.0f;  // never-observed pixels: gradient 0
    } else {
      denom = n_real;
      zero = 1.0f;
    }
  };
  if (has_f) {
    // dF[i] = dRHS_F[i] + sum_j dG[ij] F[j] with the old F (the diagonal
    // triangle entry counts twice, the off-diagonal ones hold dG[ij]+dG[ji])
    float denom, zero;
    norm(fpl, denom, zero);
    float df = sacc[NT + fi][fpl];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float dg = sacc[qfa::tri_idx(fi, j)][fpl];
      if (fi == j) dg = dg + dg;
      df = df + dg * f_sm[fpl][j];
    }
    df = df / denom * zero;
    a.F[fe] = adam(a, f_old, df, f_m, f_v, lr, bc1, bc2);
    a.mF[fe] = f_m;
    a.vF[fe] = f_v;
  }
  if (has_psi || has_omega) {
    float denom, zero;
    norm(pl, denom, zero);
    const float g = sacc[X + (has_psi ? A_PSI : A_OMEGA)][pl] / denom * zero;
    const float xn = clip(adam(a, x_old, g, x_m, x_v, lr, bc1, bc2), a.vmin,
                          a.vmax);
    if (has_psi) {
      a.psi[p] = xn;
      a.mpsi[p] = x_m;
      a.vpsi[p] = x_v;
    } else {
      a.omega[p] = xn;
      a.momega[p] = x_m;
      a.vomega[p] = x_v;
    }
  }
  // the block's dtau0, dc0 and dbeta terms, summed over its pixels by
  // warp 2 (every warp runs the shuffles; the others add zeros)
  float st[3] = {0.0f, 0.0f, 0.0f};
  if (has_srow) {
    st[0] = sacc[X + A_T0][pl];
    st[1] = -sacc[X + A_C0][pl];
    st[2] = tau0 * sacc[X + A_BETA][pl];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      st[k] += __shfl_down_sync(0xffffffffu, st[k], o);
  }
  if (tid == 64) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.spart[k * a.n_upd_pad + blockIdx.x] = st[k];
  }
  // the scalars' step runs in the next batch's forward, or here after the
  // call's last batch
  if (!last_batch ||
      !last_to_arrive(a.counters + a.n_rtiles, gridDim.x, &last) || tid >= 32)
    return;
  float s[9];
  float* cur = a.scal + 9 * (out_idx & 1);
  scalar_step(a, cur, lr, bc1, bc2, s);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) cur[k] = s[k];
  }
}

// The call's kernels, three per batch; with `early`, each but the call's
// first is launched early. The first follows the caller's copies and
// kernels in plain stream order.
template <int NH>
cudaError_t run(const EpochArgs& args, const float* sched, int n_tiles,
                int tiles_per_batch, int n_batches, int n_epochs, bool early,
                cudaStream_t s) {
  const dim3 fwd_grid((args.npix + kFwdPix - 1) / kFwdPix, args.n_rtiles);
  const dim3 bwd_grid(
      (args.npix + kBwdPix * kBwdTiles - 1) / (kBwdPix * kBwdTiles),
      args.n_chunks);
  const dim3 upd_grid((args.npix + kUpdPix - 1) / kUpdPix);
  for (int e = 0; e < n_epochs; ++e) {
    const float* sc = sched + 3 * e;
    for (int i = 0; i < n_batches; ++i) {
      const int base = e * n_tiles + i * tiles_per_batch;
      const int g = e * n_batches + i;
      const float* prev = sched + 3 * (i > 0 ? e : e - 1);  // batch g - 1's
      const bool first = g == 0, last = g + 1 == n_epochs * n_batches;
      cudaError_t err = launch(
          forward_kernel<NH>, fwd_grid, kFwdThreads, s, early && !first, args,
          base, g, first ? 0.0f : prev[0], first ? 0.0f : prev[1],
          first ? 0.0f : prev[2]);
      if (err == cudaSuccess)
        err = launch(backward_kernel<NH>, bwd_grid, kBwdThreads, s, early,
                     args, base, g);
      if (err == cudaSuccess)
        err = launch(update_kernel<NH>, upd_grid, kUpdThreads, s, early,
                     args, g, sc[0], sc[1], sc[2], last ? 1 : 0);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

cudaError_t run_nh(int nh, const EpochArgs& args, const float* sched,
                   int n_tiles, int tpb, int n_batches, int n_epochs,
                   bool early, cudaStream_t s) {
  switch (nh) {
    case 1: return run<1>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 2: return run<2>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 3: return run<3>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 4: return run<4>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 5: return run<5>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 6: return run<6>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 7: return run<7>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 8: return run<8>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 9: return run<9>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    case 10: return run<10>(args, sched, n_tiles, tpb, n_batches, n_epochs, early, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of the forward partials (fpart) for these shapes.
long long qfa_train_epoch_fpart_len(int npix, int batch_rows, int nh) {
  const long long nv = nh * (nh + 1) / 2 + nh + 3;
  return static_cast<long long>((npix + kFwdPix - 1) / kFwdPix) * batch_rows *
         nv;
}

// Arrival counters for these shapes: one per forward row tile, one for
// the update.
int qfa_train_epoch_n_counters(int npix, int batch_rows) {
  (void)npix;
  return (batch_rows + kRowTile - 1) / kRowTile + 1;
}

// Run n_epochs training epochs of n_batches batches each on `stream` of
// `device`, updating F..vomega in place and writing the per-batch loss
// sums and n_real. scal is (2, 9): tau0, c0, beta, their m, their v in
// row 0 on entry, and in row (n_epochs * n_batches - 1) % 2 on exit.
// delta and error are float32 (planes_bf16 = 0) or bfloat16 (1). hp
// (host, HP_* slots) and sched (host, (n_epochs, 3) lr, bc1, bc2) are read
// here; every other pointer is device memory, spart (scratch) holds at
// least 3 * npix + 16 zeros and is 16-byte aligned, and counters
// (qfa_train_epoch_n_counters ints) must be zero. With early = 0
// no kernel is launched early, so each starts when the one before it has
// ended (for timing each one alone). Returns the first cudaGetLastError()
// that is not cudaSuccess (0 = every kernel launched); nothing is
// synchronised. nh must be 1..10.
int qfa_train_epoch(
    const void* delta, const void* error, int planes_bf16, const float* zabs,
    int zabs_ld, const float* mask, const float* loglam, const int* perm,
    int n_tiles, int tile_batch, int tiles_per_batch, int n_batches,
    int n_epochs, int npix, int nb, int nh, int derive_mask, int derive_zabs,
    int mxu_bf16, float* F, float* psi, float* omega, float* mF, float* vF,
    float* mpsi, float* vpsi, float* momega, float* vomega, float* scal,
    const float* hp, const float* sched, float* S, float* alpha,
    float* rowstat, float* fpart, long long fpart_len, float* partials,
    float* spart, int* counters, int n_counters, float* loss_out,
    float* nreal_out, int n_chunks, int early, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int batch_rows = tiles_per_batch * tile_batch;
  if (batch_rows <= 0 || n_batches <= 0 || n_epochs <= 0 || npix <= 0 ||
      n_chunks != (batch_rows + kChunk - 1) / kChunk ||
      fpart_len < qfa_train_epoch_fpart_len(npix, batch_rows, nh) ||
      n_counters < qfa_train_epoch_n_counters(npix, batch_rows))
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
  args.fpart = fpart;
  args.partials = partials;
  args.n_upd_pad = ((npix + kUpdPix - 1) / kUpdPix + 3) / 4 * 4;
  args.spart = spart;
  args.books = spart + 3 * args.n_upd_pad;
  args.counters = counters;
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
  args.planes_bf16 = planes_bf16;
  args.npix = npix;
  args.nb = nb;
  args.zabs_ld = zabs_ld;
  args.derive_mask = derive_mask;
  args.derive_zabs = derive_zabs;
  args.tile_batch = tile_batch;
  args.batch_rows = batch_rows;
  args.n_chunks = n_chunks;
  args.n_rtiles = (batch_rows + kRowTile - 1) / kRowTile;
  err = run_nh(nh, args, sched, n_tiles, tiles_per_batch, n_batches,
               n_epochs, early != 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
