// Fused QFA prediction kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel qfa_tpu/ops/infer_kernel.py::_predict_kernel
// (Pallas; wrapper fused_predict). For each spectrum it computes the
// blue-side absorption A = exp(-tau(z)) and forest variance, the masked
// noise diagonal d = A^2 Psi + omega zdep + sigma^2, the capacitance
// K = I + sum_p w_p F_p F_p^T (w = A^2/d), the projection W = sum_p u_p F_p
// (u = A delta/d), the folded quad + logdet sum and n_obs; then the
// unrolled Cholesky K = L L^T, hmean = K^-1 W, the NLL and hcov = K^-1;
// then cont = mu + F hmean and std = ||L^-1 F_p|| = sqrt(diag(F K^-1 F^T)).
//
// What bounds it on an H100: per spectrum it reads flux and error
// (2 * 4 * Npix bytes, plus a mask or zabs plane when given) and writes
// continuum and std (2 * 4 * Npix bytes): about 30 KB at SDSS width
// (Npix 1913). Its fp32 work (ntri + nh FMAs per pixel and pass, plus the
// exp/pow/log chain on every pixel) takes about half as long on the FP32
// pipes, so the bytes bound it, if enough of them are in flight.
//
// Design:
// - One block of kWarps warps takes a tile of kWarps spectra, one warp per
//   spectrum, and walks its tiles in turn (a persistent grid of as many
//   blocks as are resident at once). A call is one launch.
// - The pixel axis is cut into chunks of kChunk. Each chunk of each pass
//   of a tile is a step of a ring of kStages stages in dynamic shared
//   memory: the chunk's F rows (transposed, so that lane-consecutive
//   pixels read consecutive words) and mu, shared by the tile's warps,
//   and in pass 1 also Psi, omega, loglam and each spectrum's flux and
//   error (and mask and zabs plane) rows. The copies are cp.async, issued
//   kStages - 1 steps ahead of the arithmetic; the step after a tile's
//   last one belongs to the next tile, so its planes stream in while this
//   tile finishes. 256-pixel chunks and one step ahead measured fastest
//   (PERF.md), ahead of warps that each walk their own spectra with F
//   read through L1 and no block barrier.
// - Plane rows are not 16-byte aligned (a row is Npix * 4 bytes). Each
//   row is kept in shared memory at the same offset mod 16 bytes as in
//   device memory, so its aligned interior moves in 16-byte copies and
//   only its head and tail in 4-byte ones.
// - Pass 1: lane l takes pixels l, l + 32, ... of each chunk and keeps the
//   [K triangle | W | quad + logdet | n_obs] sums in registers over the
//   whole spectrum; one xor butterfly gives every lane the same totals.
//   Every order is fixed, and depends on the pixel index only, so a row's
//   outputs are bitwise the same whatever its tile, neighbours and n.
// - The finish: every lane of the warp factorizes K (the same values on
//   each lane), lane b builds column b of L^-1 and of K^-1 = hcov. No
//   block waits on one thread; the other warps finish their own spectra.
// - Pass 2 (not when stats_only): cont = mu + F hmean and
//   std = ||L^-1 F_p|| (ntri + nh FMAs, never negative), lanes on
//   consecutive pixels of the row, so the stores are coalesced.
// The TPU kernel's lane-major stats block, 128-lane blue split, (rc, P)
// rhs matrix and batch tiles are TPU layout and have no counterpart here.
//
// Build without -use_fast_math: __expf/__logf in the tau chain and in
// log(d) miss the tolerances.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "smallchol.cuh"

namespace {

constexpr int kWarps = 8;                // spectra per tile, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;              // pixels per ring step
constexpr int kStages = 2;               // ring depth
constexpr int kRow = kChunk + 4;         // a plane row in shared memory
constexpr int kFRow = kChunk + 1;        // a transposed F column
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
  int n, npix, nb, zabs_ld;
  int derive_zabs;
  float* ll;     // (N,)
  float* n_obs;  // (N,)
  float* hmean;  // (N, NH)
  float* hcov;   // (N, NH, NH)
  float* cont;   // (N, npix), null when stats_only
  float* stdev;  // (N, npix), null when stats_only
};

// Offsets (floats) of one ring stage's parts; -1 marks an absent plane.
struct Layout {
  int flux, error, mask, zabs;  // kWarps rows of kRow each
  int F;                        // NH columns of kFRow
  int mu, psi, omega, loglam;   // kChunk each
  int stage;                    // floats per stage, a multiple of 4
};

template <int NH>
__host__ __device__ Layout make_layout(bool has_mask, bool derive_zabs) {
  constexpr int plane = kWarps * kRow;
  Layout L{};
  int o = 0;
  L.flux = o;
  o += plane;
  L.error = o;
  o += plane;
  L.mask = has_mask ? o : -1;
  o += has_mask ? plane : 0;
  L.zabs = derive_zabs ? -1 : o;
  o += derive_zabs ? 0 : plane;
  L.F = o;
  o += NH * kFRow;
  L.mu = o;
  L.psi = o + kChunk;
  L.omega = o + 2 * kChunk;
  L.loglam = o + 3 * kChunk;
  o += (derive_zabs ? 4 : 3) * kChunk;
  L.stage = (o + 3) & ~3;
  return L;
}

// Asynchronous copies into shared memory (cp.async) and the dynamic
// shared memory; tools/cuda_emu stands in for them on the CPU.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
#elif !defined(__CUDACC__)
  emu_cp_async(dst, src, 4);
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#elif !defined(__CUDACC__)
  emu_cp_async(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#elif !defined(__CUDACC__)
  emu_cp_async_commit();
#endif
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#elif !defined(__CUDACC__)
  emu_cp_async_wait(N);
#endif
}

__device__ __forceinline__ float* dynamic_smem() {
#if defined(__CUDA_ARCH__)
  extern __shared__ float4 smem_raw[];
  return reinterpret_cast<float*>(smem_raw);
#elif !defined(__CUDACC__)
  return emu_dynamic_smem();
#else
  return nullptr;
#endif
}

// Offset, in floats mod 4, of a row in device memory; its shared-memory
// copy sits at the same offset from a 16-byte boundary. Chunks start at
// multiples of 4 pixels, so every chunk of a row has its row's offset.
__device__ __forceinline__ int row_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// One warp copies len floats of a row into dst[off .. off + len): 16-byte
// copies where both ends are aligned, 4-byte copies at the head and tail.
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int len, int lane) {
  const int off = row_offset(src);
  const float* g = src - off;
  const int end = off + len;
  for (int q = 4 * lane; q < end; q += 4 * 32) {
    if (q >= off && q + 4 <= end) {
      cp_async16(dst + q, g + q);
    } else {
      for (int k = max(q, off); k < min(q + 4, end); ++k)
        cp_async4(dst + k, g + k);
    }
  }
}

// Issue the copies of chunk c of `tile` into stage st: pass 1 needs the
// planes and every parameter row, pass 2 only F and mu.
template <int NH>
__device__ __forceinline__ void issue_copies(const PredictArgs& a,
                                             const Layout& L, float* st,
                                             int tile, bool pass1, int c) {
  const int c0 = c * kChunk;
  const int len = min(kChunk, a.npix - c0);
  const int blen = min(len, a.nb - c0);  // blue pixels, <= 0 past nb
  const float* fsrc = a.F + static_cast<size_t>(c0) * NH;
  for (int e = threadIdx.x; e < len * NH; e += kThreads) {
    const int p = e / NH;
    cp_async4(st + L.F + (e - p * NH) * kFRow + p, fsrc + e);
  }
  for (int j = threadIdx.x; j < len; j += kThreads) {
    cp_async4(st + L.mu + j, a.mu + c0 + j);
    if (pass1) cp_async4(st + L.psi + j, a.psi + c0 + j);
  }
  if (!pass1) return;
  for (int j = threadIdx.x; j < blen; j += kThreads) {
    cp_async4(st + L.omega + j, a.omega + c0 + j);
    if (a.derive_zabs) cp_async4(st + L.loglam + j, a.loglam + c0 + j);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = tile * kWarps + warp;
  if (row >= a.n) return;
  const size_t rb = static_cast<size_t>(row) * a.npix + c0;
  copy_row(st + L.flux + warp * kRow, a.flux + rb, len, lane);
  copy_row(st + L.error + warp * kRow, a.error + rb, len, lane);
  if (a.mask != nullptr)
    copy_row(st + L.mask + warp * kRow, a.mask + rb, len, lane);
  if (!a.derive_zabs && blen > 0)
    copy_row(st + L.zabs + warp * kRow,
             a.zabs + static_cast<size_t>(row) * a.zabs_ld + c0, blen, lane);
}

// This warp's spectrum: its plane rows in a stage (each at its offset)
// and its redshift.
struct RowView {
  int flux, error, mask, zabs;  // offsets into a stage
  float log1p_zq;
};

// Pass 1 over chunk c: this lane's pixels into acc.
template <int NH>
__device__ __forceinline__ void accumulate(const PredictArgs& a,
                                           const Layout& L, const float* st,
                                           const RowView& r, int c, int lane,
                                           float tau0, float c0f, float beta,
                                           float* acc) {
  constexpr int NT = qfa::ntri(NH);
  const int c0 = c * kChunk;
  const int len = min(kChunk, a.npix - c0);
  const float* sF = st + L.F;
  for (int j = lane; j < len; j += 32) {
    const int p = c0 + j;
    const float e = st[r.error + j];
    const float m = r.mask < 0 ? (e > 0.0f ? 1.0f : 0.0f) : st[r.mask + j];
    const float f = st[r.flux + j];
    // red pixels: amp = 1, zdep = 0
    float amp = 1.0f;
    float forest = 0.0f;  // omega_p * zdep
    if (p < a.nb) {
      float tau_line, zp1b;
      if (a.derive_zabs) {
        // log(1 + zabs) = log1p(zqso) + log(lam / lam_lya): no pow/log
        const float lz = r.log1p_zq + st[L.loglam + j];
        tau_line = a.law_a * expf(a.law_b * lz) + a.law_c;
        zp1b = expf(beta * lz);
      } else {
        const float zp1 = 1.0f + st[r.zabs + j];
        tau_line = a.law_a * powf(zp1, a.law_b) + a.law_c;
        zp1b = powf(zp1, beta);
      }
      amp = expf(-tau_line);
      const float root = 1.0f - c0f - expf(-(tau0 * zp1b));
      forest = st[L.omega + j] * (root * root);
    }
    const float a2 = amp * amp;
    const float d = a2 * st[L.psi + j] + forest + e * e;
    const float delta = (f - st[L.mu + j] * amp) * m;
    // masked pixels: d_safe = 1, so dinv = 0 and log(d_safe) = 0
    const float d_safe = m > 0.0f ? d : 1.0f;
    const float dinv = m / d_safe;
    const float w = a2 * dinv;
    const float u = amp * dinv * delta;
    const float ql = delta * delta * dinv + m * logf(d_safe);
    float fr[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) fr[i] = sF[i * kFRow + j];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const float wi = w * fr[i];
#pragma unroll
      for (int k = 0; k <= i; ++k) acc[qfa::tri_idx(i, k)] += wi * fr[k];
      acc[NT + i] += u * fr[i];
    }
    acc[NT + NH] += ql;
    acc[NT + NH + 1] += m;
  }
}

// The finish of one spectrum by its warp: totals, Cholesky, NLL, hmean,
// hcov; returns hmean and the packed rows of L^-1 in every lane.
template <int NH>
__device__ __forceinline__ void finish(const PredictArgs& a, int row,
                                       int lane, float* acc, float (&al)[NH],
                                       float* li) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NV = NT + NH + 2;
  // xor butterfly: every lane ends with the same totals (a + b == b + a)
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  }
  // K = I + the triangle sums, in place
#pragma unroll
  for (int i = 0; i < NH; ++i) acc[qfa::tri_idx(i, i)] += 1.0f;
  float Lr[NH][NH], rd[NH];
  qfa::chol_rdiag<NH>(acc, Lr, rd);
  float y[NH];
  qfa::solve_lower_rdiag<NH>(Lr, rd, acc + NT, y);
  qfa::solve_upper_rdiag<NH>(Lr, rd, y, al);
  float logdet = 0.0f, yy = 0.0f, hm = 0.0f;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    logdet += logf(Lr[i][i]);
    yy += y[i] * y[i];
    if (lane == i) hm = al[i];
  }
  const float n_obs = acc[NT + NH + 1];
  if (lane == 0) {
    a.ll[row] = 0.5f * (acc[NT + NH] - yy + n_obs * kLog2Pi + 2.0f * logdet);
    a.n_obs[row] = n_obs;
  }
  if (lane < NH) a.hmean[static_cast<size_t>(row) * NH + lane] = hm;
  // lane b: column b of L^-1 and of K^-1 = L^-T L^-1
  float lcol[NH], kcol[NH];
  qfa::linv_column_rdiag<NH>(Lr, rd, lane, lcol);
  qfa::solve_upper_rdiag<NH>(Lr, rd, lcol, kcol);
  if (lane < NH) {
    float* hc = a.hcov + static_cast<size_t>(row) * NH * NH;
#pragma unroll
    for (int i = 0; i < NH; ++i) hc[i * NH + lane] = kcol[i];
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k)
      li[qfa::tri_idx(i, k)] = __shfl_sync(0xffffffffu, lcol[i], k);
  }
}

// Pass 2 over chunk c: continuum and std of this lane's pixels.
template <int NH>
__device__ __forceinline__ void emit(const PredictArgs& a, const Layout& L,
                                     const float* st, int row, int c,
                                     int lane, const float (&al)[NH],
                                     const float* li) {
  const int c0 = c * kChunk;
  const int len = min(kChunk, a.npix - c0);
  const float* sF = st + L.F;
  const size_t rb = static_cast<size_t>(row) * a.npix + c0;
  for (int j = lane; j < len; j += 32) {
    float fr[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) fr[i] = sF[i * kFRow + j];
    float cv = 0.0f, var = 0.0f;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      cv += al[i] * fr[i];
      float yi = 0.0f;
#pragma unroll
      for (int k = 0; k <= i; ++k) yi += li[qfa::tri_idx(i, k)] * fr[k];
      var += yi * yi;
    }
    a.cont[rb + j] = cv + st[L.mu + j];
    a.stdev[rb + j] = sqrtf(var);
  }
}

template <int NH>
__global__ void __launch_bounds__(kThreads, 2) predict_kernel(PredictArgs a) {
  constexpr int NT = qfa::ntri(NH);
  constexpr int NV = NT + NH + 2;  // [K tri | W | sum quad+logdet | n_obs]
  float* const smem = dynamic_smem();
  const Layout L = make_layout<NH>(a.mask != nullptr, a.derive_zabs != 0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_chunks = (a.npix + kChunk - 1) / kChunk;
  const bool full = a.cont != nullptr;
  const int per_tile = full ? 2 * n_chunks : n_chunks;
  const int n_tiles = (a.n + kWarps - 1) / kWarps;
  const int my_tiles = (n_tiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1;
  const int n_steps = my_tiles * per_tile;
  const float tau0 = __ldg(a.tau0);
  const float c0f = __ldg(a.c0);
  const float beta = __ldg(a.beta);

  // Step s of this block: chunk r of its tile k's pass 1 (r < n_chunks)
  // or pass 2. Every thread commits one group per step, empty past the
  // last, so that its count of groups stays in step with the ring.
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int k = s / per_tile;
      const int r = s - k * per_tile;
      const int tile = static_cast<int>(blockIdx.x + k * gridDim.x);
      issue_copies<NH>(a, L, smem + (s % kStages) * L.stage, tile,
                       r < n_chunks, r < n_chunks ? r : r - n_chunks);
    }
    cp_async_commit();
  };
  // Wait for step s's copies; every warp is done with step s - 1, whose
  // stage then takes step s + kStages - 1.
  auto begin = [&](int s) -> const float* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    return smem + (s % kStages) * L.stage;
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int s = 0;
  for (int k = 0; k < my_tiles; ++k) {
    const int row =
        static_cast<int>(blockIdx.x + k * gridDim.x) * kWarps + warp;
    const bool live = row < a.n;
    RowView r{L.flux + warp * kRow, L.error + warp * kRow, -1, -1, 0.0f};
    if (live) {
      const size_t rb = static_cast<size_t>(row) * a.npix;
      r.flux += row_offset(a.flux + rb);
      r.error += row_offset(a.error + rb);
      if (a.mask != nullptr)
        r.mask = L.mask + warp * kRow + row_offset(a.mask + rb);
      const float* zrow = a.zabs + static_cast<size_t>(row) * a.zabs_ld;
      if (a.derive_zabs)
        r.log1p_zq = __ldg(zrow);
      else
        r.zabs = L.zabs + warp * kRow + row_offset(zrow);
    }
    float acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
    for (int c = 0; c < n_chunks; ++c, ++s) {
      const float* st = begin(s);
      if (live) accumulate<NH>(a, L, st, r, c, lane, tau0, c0f, beta, acc);
    }
    float al[NH], li[NT];
    if (live) finish<NH>(a, row, lane, acc, al, li);
    if (!full) continue;
    for (int c = 0; c < n_chunks; ++c, ++s) {
      const float* st = begin(s);
      if (live) emit<NH>(a, L, st, row, c, lane, al, li);
    }
  }
  cp_async_wait<0>();
}

template <int NH>
int smem_bytes(bool has_mask, bool derive_zabs) {
  return kStages * make_layout<NH>(has_mask, derive_zabs).stage *
         static_cast<int>(sizeof(float));
}

// Dynamic shared memory per block and resident blocks per SM.
template <int NH>
cudaError_t occupancy(bool has_mask, bool derive_zabs, int* bytes,
                      int* per_sm) {
  *bytes = smem_bytes<NH>(has_mask, derive_zabs);
  void (*kernel)(PredictArgs) = predict_kernel<NH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, *bytes);
}

// One launch: a persistent grid of min(tiles, resident blocks) blocks.
template <int NH>
cudaError_t launch(const PredictArgs& args, int device, cudaStream_t s) {
  int bytes = 0, per_sm = 0, sms = 0;
  cudaError_t err = occupancy<NH>(args.mask != nullptr,
                                  args.derive_zabs != 0, &bytes, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (args.n + kWarps - 1) / kWarps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles < per_sm * sms ? tiles : per_sm * sms);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = s;
  return cudaLaunchKernelEx(&cfg, predict_kernel<NH>, args);
}

// nh's launch, and nh's launch geometry, for nh in 1..10.
cudaError_t dispatch(int nh, const PredictArgs& args, int device,
                     cudaStream_t s) {
  switch (nh) {
    case 1: return launch<1>(args, device, s);
    case 2: return launch<2>(args, device, s);
    case 3: return launch<3>(args, device, s);
    case 4: return launch<4>(args, device, s);
    case 5: return launch<5>(args, device, s);
    case 6: return launch<6>(args, device, s);
    case 7: return launch<7>(args, device, s);
    case 8: return launch<8>(args, device, s);
    case 9: return launch<9>(args, device, s);
    case 10: return launch<10>(args, device, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t geometry(int nh, bool has_mask, bool derive_zabs, int* bytes,
                     int* per_sm) {
  switch (nh) {
    case 1: return occupancy<1>(has_mask, derive_zabs, bytes, per_sm);
    case 2: return occupancy<2>(has_mask, derive_zabs, bytes, per_sm);
    case 3: return occupancy<3>(has_mask, derive_zabs, bytes, per_sm);
    case 4: return occupancy<4>(has_mask, derive_zabs, bytes, per_sm);
    case 5: return occupancy<5>(has_mask, derive_zabs, bytes, per_sm);
    case 6: return occupancy<6>(has_mask, derive_zabs, bytes, per_sm);
    case 7: return occupancy<7>(has_mask, derive_zabs, bytes, per_sm);
    case 8: return occupancy<8>(has_mask, derive_zabs, bytes, per_sm);
    case 9: return occupancy<9>(has_mask, derive_zabs, bytes, per_sm);
    case 10: return occupancy<10>(has_mask, derive_zabs, bytes, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the prediction kernel for n spectra on `stream` of `device`.
// Returns the launch's error code (0 = launched); nothing is
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
  const PredictArgs args{flux,  error,  zabs,  derive_mask ? nullptr : mask,
                         mu,    F,      psi,   omega,
                         loglam, tau0,  c0,    beta,
                         law_a, law_b,  law_c, n,
                         npix,  nb,     zabs_ld, derive_zabs,
                         ll,    n_obs,  hmean, hcov,
                         cont,  stdev};
  err = dispatch(nh, args, device, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The launch geometry of nh's kernel in a mode: dynamic shared memory per
// block (bytes) and resident blocks per SM on `device`. Returns the error
// code (0 = ok).
int qfa_predict_occupancy(int nh, int derive_mask, int derive_zabs,
                          int device, int* smem, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      geometry(nh, derive_mask == 0, derive_zabs != 0, smem, blocks_per_sm));
}

const char* qfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
