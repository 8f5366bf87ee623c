// Contraction-depth probe kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel tools/mxu_kdepth.py::_body (tools/mxu_kdepth.py:87,
// Pallas; make_fn at :139). It replicates the shapes of the training
// kernels' backward products, dw = S.G over ntri = 36 and du over nh = 8:
// (K, TB)^T @ (K, P) -> (TB, P), TB 256, P 1920, K from 8 to 128, and
// accumulates G sequential steps into one (TB, P) output. Step j scales
// the left operand by s_j = 1 + j * 1e-9 (rounded in f32, applied to the
// operand before the contraction, as JAX does), then
//   o += dw * 0.5 + du * 0.25      (variants with a second contraction)
//   o += dw * 0.5                  (single K)
// with dw = (s_j L[:K1])^T R[:K1] and du = (s_j L[K1:K1+K2])^T R[K1:K1+K2].
// Modes (tools/mxu_kdepth.py VARIANTS):
//   kMxu   both contractions read L (JAX's MXU dots);
//   kVpu   du reads the transposed operand LT (JAX's K2 broadcast-fma
//          outer products on the VPU); K1 = 0 leaves dw out (dw = 0.0);
//   kWide  one K = K1 + K2 contraction against the block-diagonal R2
//          (KMAX, 2P): o += wide[:, :P] * 0.5 + wide[:, P:] * 0.25.
//
// Design: the TPU's two units map onto the card's two.
// * Every contraction JAX writes as a dot_general (the MXU's) runs on the
//   tensor cores, mma.sync m16n8k8 with TF32 operands and f32 sums, in the
//   3xTF32 split: x = x_hi + x_lo, each part rounded to TF32 (as cvt.rna),
//   and a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32, small terms
//   first. That keeps close to f32 accuracy; one TF32 pass keeps ~3
//   digits. Each depth is padded to a multiple of 8 with zero rows in
//   shared memory (36 -> 40, 44 -> 48). Inside one 8-deep product, MMA
//   depth slot t holds the pair's row 2t and slot t + 4 row 2t + 1, for A
//   and B alike, so one 8-byte load gives a thread both of its A values of
//   a row and one 16-byte load its B hi and lo pairs.
// * The VPU contraction stays f32 FFMA on the CUDA cores, computed for the
//   output elements each thread's MMA accumulators hold, so the combine
//   stays in registers.
// * A block owns a 64 x 128 output tile (four warps of 32 x 64: 60 tiles
//   for the 132 SMs), stages its slices of L, LT, R or R2 once (R split
//   into its hi and lo TF32 parts as it is staged), and loops over a chunk
//   of the G steps; every step reads its A values from shared memory again
//   (a compiler barrier per step), scales, splits and multiplies them. The
//   G steps are split into S chunks across blocks (grid tiles x S), each
//   writing its partial sum; a second launch adds the partials in chunk
//   order. No atomics: a repeat call gives the same bits. S is the fewest
//   chunks that fill whole waves of the card's resident blocks
//   (qfa_kdepth_chunks).
//
// What bounds it on an H100: tensor-core operations. pair36+8 at G = 4096
// asks 2 * 256 * 1920 * 44 * 4096 = 177 GFLOP, three TF32 passes of it
// 1.07 ms at 495 TFLOP/s dense (700 W), against ~2.9 MB of operands and
// output. mma.sync does not reach the full tensor rate on Hopper (wgmma
// does): on an H100 80GB HBM3 at 700 W the MMAs alone, on register
// operands, take 2.25-2.27 ms on the device of the kernel's 2.32-2.39
// (kdepth_variants.py, mma_only). The warp tile of 32 x 64 splits each A
// value once for 8 column tiles and reads 5 KB of shared memory per 8-deep product for
// 48 MMAs, under half the SM's shared-memory rate at that MMA rate.
//
// Built without -use_fast_math; the step scale, the operand products and
// the splits use __fmul_rn / __fsub_rn so that nvcc contracts none of
// them into an FMA (JAX rounds each).

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <numeric>

namespace {

constexpr int kBM = 64;   // output rows (TB) per block
constexpr int kBN = 128;  // output columns (P) per block
constexpr int kWM = 32;   // ... per warp
constexpr int kWN = 64;
constexpr int kMT = kWM / 16;  // m16n8 tiles of a warp
constexpr int kNT = kWN / 8;
constexpr int kThreads = 32 * (kBM / kWM) * (kBN / kWN);
constexpr int kMinBlocks = 2;   // per SM: at most 255 registers a thread
constexpr int kVpuK = 8;        // depth of the VPU contraction
constexpr int kMaxChunks = 64;  // S at most
constexpr int kSumThreads = 256;
constexpr int kMaxDevices = 64;

enum Mode { kMxu = 0, kVpu = 1, kWide = 2 };

struct ProbeArgs {
  const float* l;   // (kmax, tb)
  const float* lt;  // (tb, kmax)
  const float* r;   // (kmax, p)
  const float* r2;  // (kmax, 2p)
  float* dst;       // (chunks, tb, p) partials; the output when chunks == 1
  int kmax, tb, p, grid, chunks;
};

constexpr int pad8(int k) { return (k + 7) / 8 * 8; }
// Row strides, in floats, of the staged tiles, so that a warp's fragment
// loads meet no bank conflict: A's 8-byte loads (half-warps: rows g 0..3 at
// offsets 2t) need a stride of 8 or 24 mod 32; B's 16-byte loads
// (quarter-warps: rows g 0, 1 at offsets 4t) one of 16 mod 32.
constexpr int a_stride(int k) {
  return k % 32 == 8 || k % 32 == 24 ? k : k + 8;
}
constexpr int b_stride(int k) { return 2 * k % 32 == 16 ? 2 * k : 2 * k + 16; }

// A variant's staged depths and shared memory, in floats: A = L^T
// ([kBM][kSA], padded depths side by side), B's hi/lo pairs per plane
// ([kBN][kSB]; kWide has R2's two halves), and for kVpu LT's du columns
// ([kBM][8]) and R's du rows ([8][kBN]) in f32.
template <int K1, int K2, int MODE>
struct Shape {
  static_assert(MODE != kVpu || K2 == kVpuK, "the VPU contraction is 8 deep");
  static constexpr int kDw = MODE == kWide ? pad8(K1 + K2) : pad8(K1);
  static constexpr int kDu = MODE == kMxu ? pad8(K2) : 0;
  static constexpr int kA = kDw + kDu;  // depth staged for the MMAs
  static constexpr int kSA = a_stride(kA), kSB = b_stride(kA);
  static constexpr int kAFloats = kA ? kBM * kSA : 0;
  static constexpr int kBFloats = kA ? (MODE == kWide ? 2 : 1) * kBN * kSB : 0;
  static constexpr int kLtFloats = MODE == kVpu ? kBM * kVpuK : 0;
  static constexpr int kRvFloats = MODE == kVpu ? kVpuK * kBN : 0;
  static constexpr int kFloats = kAFloats + kBFloats + kLtFloats + kRvFloats;
};

// The row of L and R that staged depth kk holds, or -1 for a zero pad row.
template <int K1, int K2, int MODE>
__device__ __forceinline__ int logical_row(int kk) {
  using S = Shape<K1, K2, MODE>;
  if (MODE == kWide) return kk < K1 + K2 ? kk : -1;
  if (kk < S::kDw) return kk < K1 ? kk : -1;
  kk -= S::kDw;
  return kk < K2 ? K1 + kk : -1;
}

// The dynamic shared memory and the tensor-core product; tools/cuda_emu
// stands in for them on the CPU.
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

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero, the 13 low bits cleared. Two integer operations;
// cvt.rna took up to 5 % more time per call on the wider variants
// (kdepth_variants.py, cvt_split).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += A B over one m16n8k8 tile of the warp. Fragments (PTX ISA, g =
// lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g, 2t and
// 2t + 1), d2, d3 (g + 8, 2t and 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k8_tf32(d, a, b0, b1);
#endif
}

// The warp's A fragments of 8-deep product c, scaled by s and split: aw
// points at its row g, depth 2t.
template <int SA>
__device__ __forceinline__ void load_a(const float* aw, int c, float s,
                                       uint32_t (&hi)[kMT][4],
                                       uint32_t (&lo)[kMT][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const float2 x =
        *reinterpret_cast<const float2*>(aw + mt * 16 * SA + 8 * c);
    const float2 y =
        *reinterpret_cast<const float2*>(aw + (mt * 16 + 8) * SA + 8 * c);
    const float v[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__fmul_rn(v[i], s), hi[mt][i], lo[mt][i]);
  }
}

// acc += A B over 8-deep product c in three TF32 passes, small terms
// first: bw points at the warp's B row (column n = g), depth pair 4t.
template <int SB>
__device__ __forceinline__ void products(float (&acc)[kMT][kNT][4],
                                         const uint32_t (&hi)[kMT][4],
                                         const uint32_t (&lo)[kMT][4],
                                         const float* bw, int c) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float4 b =
        *reinterpret_cast<const float4*>(bw + nt * 8 * SB + 16 * c);
    const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
    const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      mma_tf32(acc[mt][nt], lo[mt], bh0, bh1);
      mma_tf32(acc[mt][nt], hi[mt], bl0, bl1);
      mma_tf32(acc[mt][nt], hi[mt], bh0, bh1);
    }
  }
}

// du of the VPU variants on the CUDA cores, for the elements of the
// accumulators' layout: rows wm + 16 mt + 8 h + g, columns wn + 8 nt + 2t
// + q; du = sum over jj of (s LT[row][jj]) R[jj][col], FFMAs in jj order.
__device__ __forceinline__ void vpu_du(float (&du)[kMT][kNT][4],
                                       const float* lts, const float* rvs,
                                       float s, int wm, int wn, int g,
                                       int t) {
  float ls[kMT][2][kVpuK];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4* row = reinterpret_cast<const float4*>(
          lts + (wm + 16 * mt + 8 * h + g) * kVpuK);
      const float4 x = row[0], y = row[1];
      const float v[kVpuK] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int jj = 0; jj < kVpuK; ++jj) ls[mt][h][jj] = __fmul_rn(v[jj], s);
    }
#pragma unroll
  for (int jj = 0; jj < kVpuK; ++jj)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 rv = *reinterpret_cast<const float2*>(
          rvs + jj * kBN + wn + 8 * nt + 2 * t);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* d = du[mt][nt] + 2 * h;
          d[0] = fmaf(ls[mt][h][jj], rv.x, d[0]);
          d[1] = fmaf(ls[mt][h][jj], rv.y, d[1]);
        }
    }
}

template <int K1, int K2, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    kdepth_kernel(const ProbeArgs a) {
  using S = Shape<K1, K2, MODE>;
  float* as = dynamic_smem();            // [kBM][kSA]
  float* bs = as + S::kAFloats;          // [planes][kBN][kSB]
  float* lts = bs + S::kBFloats;         // [kBM][kVpuK]
  float* rvs = lts + S::kLtFloats;       // [kVpuK][kBN]
  const int tiles_n = a.p / kBN;
  const int row0 = static_cast<int>(blockIdx.x) / tiles_n * kBM;
  const int col0 = static_cast<int>(blockIdx.x) % tiles_n * kBN;
  const int tid = threadIdx.x;

  // stage the block's operand slices once; pad rows hold zeros
  for (int e = tid; e < S::kA * kBM; e += kThreads) {
    const int kk = e / kBM, m = e % kBM;
    const int k = logical_row<K1, K2, MODE>(kk);
    as[m * S::kSA + kk] =
        k < 0 ? 0.0f : a.l[static_cast<size_t>(k) * a.tb + row0 + m];
  }
  for (int plane = 0; plane < S::kBFloats / (kBN * S::kSB); ++plane) {
    const float* src = MODE == kWide ? a.r2 + plane * a.p : a.r;
    const int ld = MODE == kWide ? 2 * a.p : a.p;
    float* dst = bs + plane * kBN * S::kSB;
    for (int e = tid; e < S::kA * kBN; e += kThreads) {
      const int kk = e / kBN, n = e % kBN;
      const int k = logical_row<K1, K2, MODE>(kk);
      const float v =
          k < 0 ? 0.0f : src[static_cast<size_t>(k) * ld + col0 + n];
      uint32_t hi, lo;
      split(v, hi, lo);
      // depth kk = 8c + 2u + w sits in MMA slot u + 4w of product c
      const int q = kk % 8;
      float* slot = dst + n * S::kSB + kk / 8 * 16 + q / 2 * 4 + q % 2;
      slot[0] = __uint_as_float(hi);
      slot[2] = __uint_as_float(lo);
    }
  }
  for (int e = tid; e < S::kLtFloats; e += kThreads)
    lts[e] = a.lt[static_cast<size_t>(row0 + e / kVpuK) * a.kmax + K1 +
                  e % kVpuK];
  for (int e = tid; e < S::kRvFloats; e += kThreads)
    rvs[e] = a.r[static_cast<size_t>(K1 + e / kBN) * a.p + col0 + e % kBN];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / (kBN / kWN) * kWM, wn = warp % (kBN / kWN) * kWN;
  const float* aw = as + (wm + g) * S::kSA + 2 * t;
  const float* bw = bs + (wn + g) * S::kSB + 4 * t;
  const long long chunk = blockIdx.y;
  const int j0 = static_cast<int>(a.grid * chunk / a.chunks);
  const int j1 = static_cast<int>(a.grid * (chunk + 1) / a.chunks);

  float o[kMT][kNT][4] = {};
  for (int j = j0; j < j1; ++j) {
    // compiler barrier: every step reads its operands from shared memory
    // again, as every TPU grid step reads VMEM; the per-step scale keeps
    // every step's products distinct, so none can leave the loop
    asm volatile("" ::: "memory");
    const float s = __fadd_rn(1.0f, __fmul_rn(static_cast<float>(j), 1e-9f));
    float dw[kMT][kNT][4] = {}, du[kMT][kNT][4] = {};
    uint32_t hi[kMT][4], lo[kMT][4];
    if (MODE == kWide) {
#pragma unroll 2
      for (int c = 0; c < S::kDw / 8; ++c) {
        load_a<S::kSA>(aw, c, s, hi, lo);
        products<S::kSB>(dw, hi, lo, bw, c);
        products<S::kSB>(du, hi, lo, bw + kBN * S::kSB, c);
      }
    } else {
#pragma unroll 2
      for (int c = 0; c < S::kDw / 8; ++c) {
        load_a<S::kSA>(aw, c, s, hi, lo);
        products<S::kSB>(dw, hi, lo, bw, c);
      }
#pragma unroll
      for (int c = S::kDw / 8; c < S::kA / 8; ++c) {
        load_a<S::kSA>(aw, c, s, hi, lo);
        products<S::kSB>(du, hi, lo, bw, c);
      }
      if (MODE == kVpu) vpu_du(du, lts, rvs, s, wm, wn, g, t);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the products by 0.5 and 0.25 are exact: contraction changes
          // nothing in these lines
          if (K2 == 0)
            o[mt][nt][e] += dw[mt][nt][e] * 0.5f;
          else if (K1 == 0)
            o[mt][nt][e] += du[mt][nt][e] * 0.25f;
          else
            o[mt][nt][e] += dw[mt][nt][e] * 0.5f + du[mt][nt][e] * 0.25f;
        }
  }
  float* dst = a.dst + chunk * a.tb * a.p;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + 16 * mt + 8 * h + g;
        const int col = col0 + wn + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * a.p +
                                   col) =
            make_float2(o[mt][nt][2 * h], o[mt][nt][2 * h + 1]);
      }
}

// out = the chunks' partials summed in chunk order, four floats a thread
__global__ void __launch_bounds__(kSumThreads)
    kdepth_sum_kernel(const float4* part, float4* out, int n4, int chunks) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n4) return;
  float4 acc = part[i];
  for (int c = 1; c < chunks; ++c) {
    const float4 v = part[static_cast<size_t>(c) * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[i] = acc;
}

template <int A, int B, int M>
struct Variant {
  static constexpr int k1 = A, k2 = B, mode = M;
};

// f(Variant<K1, K2, MODE>{}) for the probe's variants
// (tools/mxu_kdepth.py VARIANTS), else cudaErrorInvalidValue.
template <class F>
cudaError_t visit(int k1, int k2, int mode, F f) {
  switch ((k1 * 1000 + k2) * 10 + mode) {
    case (36 * 1000 + 8) * 10 + kMxu: return f(Variant<36, 8, kMxu>{});
    case (8 * 1000 + 0) * 10 + kMxu: return f(Variant<8, 0, kMxu>{});
    case (44 * 1000 + 0) * 10 + kMxu: return f(Variant<44, 0, kMxu>{});
    case (64 * 1000 + 0) * 10 + kMxu: return f(Variant<64, 0, kMxu>{});
    case (128 * 1000 + 0) * 10 + kMxu: return f(Variant<128, 0, kMxu>{});
    case (0 * 1000 + 8) * 10 + kVpu: return f(Variant<0, 8, kVpu>{});
    case (36 * 1000 + 8) * 10 + kVpu: return f(Variant<36, 8, kVpu>{});
    case (36 * 1000 + 8) * 10 + kWide: return f(Variant<36, 8, kWide>{});
    default: return cudaErrorInvalidValue;
  }
}

// The variant's dynamic shared memory, set as the kernel's limit on the
// current device at its first launch there (the setting stays).
template <int K1, int K2, int MODE>
cudaError_t smem_bytes(int device, int* bytes) {
  static std::atomic<bool> set[kMaxDevices];
  *bytes = Shape<K1, K2, MODE>::kFloats * static_cast<int>(sizeof(float));
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && set[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kdepth_kernel<K1, K2, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err == cudaSuccess && known) set[device].store(true);
  return err;
}

// ... and its resident blocks per SM.
template <int K1, int K2, int MODE>
cudaError_t occupancy(int device, int* bytes, int* per_sm) {
  const cudaError_t err = smem_bytes<K1, K2, MODE>(device, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kdepth_kernel<K1, K2, MODE>, kThreads, *bytes);
}

// S for `tiles` output tiles, `slots` resident blocks and G steps: the
// fewest chunks that fill whole waves, slots / gcd(tiles, slots), so that
// every slot runs as many blocks (22 for the probe's 60 tiles at 2 blocks
// per SM of an H100, 11 at one), at most 64 and G. Against every S from 1
// to 64 on the device (kdepth_variants.py) it timed within 1 % of the best
// S for every variant but single8 (1-5 %); one wave, S = slots / tiles,
// 8-12 % slower for all but vpu8 (2 %); S = 11 for all (whole waves of
// SMs, not of slots), 17 % slower for vpu8.
int pick_chunks(int tiles, int slots, int grid) {
  const int s = slots / std::gcd(tiles, slots);
  return std::max(1, std::min({s, kMaxChunks, grid}));
}

bool bad_shape(int tb, int p, int grid) {
  return tb <= 0 || p <= 0 || tb % kBM != 0 || p % kBN != 0 || grid < 0;
}

// Run fn() with `device` current, and leave the thread's current device
// as it was.
template <class F>
cudaError_t on_device(int device, F fn) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fn();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

}  // namespace

extern "C" {

// The number of chunks S that qfa_kdepth_f32 should split the grid steps
// of variant (k1, k2, mode) at these shapes into on `device`, written to
// *chunks. Returns 0, or a CUDA error (cudaErrorInvalidValue for a shape
// or variant the kernel does not take).
int qfa_kdepth_chunks(int tb, int p, int k1, int k2, int mode, int grid,
                      int device, int* chunks) {
  if (bad_shape(tb, p, grid)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(on_device(device, [&] {
    return visit(k1, k2, mode, [&](auto v) {
      using V = decltype(v);
      int bytes = 0, per_sm = 0, sms = 0;
      cudaError_t err =
          occupancy<V::k1, V::k2, V::mode>(device, &bytes, &per_sm);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return err;
      *chunks = pick_chunks(tb / kBM * (p / kBN), per_sm * sms, grid);
      return cudaSuccess;
    });
  }));
}

// G = grid steps of the probe variant (k1, k2, mode) on `stream` of
// `device`, split into `chunks` chunks (1 <= chunks <= max(grid, 1), at
// most 64; qfa_kdepth_chunks gives the one to use); mode 0: both
// contractions read l, 1: the second reads lt, 2: one contraction against
// the block-diagonal r2 (k1 + k2 rows). Every pointer is device memory,
// row-major: l (kmax, tb), lt (tb, kmax), r (kmax, p), r2 (kmax, 2p), out
// (tb, p); with chunks > 1, partials holds partials_len >= chunks * tb * p
// floats of scratch. tb must be a multiple of 64, p of 128, k1 + k2 <=
// kmax; the variants are those of tools/mxu_kdepth.py. Returns the first
// launch error (0 = launched); nothing is synchronised. Leaves the
// thread's current device as it was.
int qfa_kdepth_f32(const float* l, const float* lt, const float* r,
                   const float* r2, float* out, float* partials,
                   long long partials_len, int kmax, int tb, int p, int k1,
                   int k2, int mode, int grid, int chunks, int device,
                   void* stream) {
  if (bad_shape(tb, p, grid) || k1 < 0 || k2 < 0 || k1 + k2 > kmax ||
      chunks < 1 || chunks > kMaxChunks || chunks > (grid > 1 ? grid : 1) ||
      (chunks > 1 &&
       (partials == nullptr ||
        partials_len < static_cast<long long>(chunks) * tb * p)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ProbeArgs a{l, lt, r, r2, chunks > 1 ? partials : out,
                    kmax, tb, p, grid, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    return visit(k1, k2, mode, [&](auto v) {
      using V = decltype(v);
      int bytes = 0;
      cudaError_t err = smem_bytes<V::k1, V::k2, V::mode>(device, &bytes);
      if (err != cudaSuccess) return err;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(tb / kBM * (p / kBN), chunks);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
      cfg.stream = s;
      err = cudaLaunchKernelEx(&cfg, kdepth_kernel<V::k1, V::k2, V::mode>,
                               a);
      if (err != cudaSuccess || chunks == 1) return err;
      const int n4 = tb * p / 4;
      cfg.gridDim = dim3((n4 + kSumThreads - 1) / kSumThreads);
      cfg.blockDim = dim3(kSumThreads);
      cfg.dynamicSmemBytes = 0;
      return cudaLaunchKernelEx(&cfg, kdepth_sum_kernel,
                                reinterpret_cast<const float4*>(partials),
                                reinterpret_cast<float4*>(out), n4, chunks);
    });
  }));
}

}  // extern "C"
