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
//          outer products on the VPU; here the same FP32 FMAs, kept for
//          their inputs and meaning); K1 = 0 leaves dw out (dw = 0.0);
//   kWide  one K = K1 + K2 contraction against the block-diagonal R2
//          (KMAX, 2P): o += wide[:, :P] * 0.5 + wide[:, P:] * 0.25.
//
// Design: the TPU grid of G steps is sequential with the output block
// resident; here each block owns a 32 x 64 output tile (240 blocks for the
// 132 SMs), stages its slices of L, LT, R or R2 in shared memory once (the
// TPU kernel's constant index_map: no per-step copy), and loops over the G
// steps inside the kernel. Each of its 128 threads keeps a 4 x 4 micro-tile
// of the output and of dw and du in registers; per contraction row it
// reads one float4 of L (broadcast to the 16 lanes that share its rows)
// and one of R, scales the four L values by s_j and issues 16 FFMAs; the
// contraction loops unroll by 4, so the code of K = 128 stays small. A
// contraction whose operands did not change could be moved out of the
// step loop; the per-step scale of the operand, rounded per step, keeps
// every step's contraction distinct (the time grows with G), and a
// compiler barrier per step keeps the operands' loads inside the loop.
//
// What bounds it on an H100: FP32 operations. pair36+8 at G = 4096 does
// 2 * 256 * 1920 * 44 * 4096 = 177 GFLOP (2.65 ms at 67 TFLOP/s, 700 W)
// against ~2.9 MB of operands and output (under 1 us at 3.35 TB/s). The
// design pays one FMUL per four FFMAs for the per-step scale and two
// shared-memory loads per 16 FFMAs. Tensor cores (mma.sync or wgmma in
// TF32 or bf16) are for the redesign of the training kernels.
//
// Built without -use_fast_math; the step scale and the operand products
// use __fmul_rn / __fadd_rn so that nvcc does not contract them into an
// FMA (JAX rounds each).

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;   // output rows (TB) per block
constexpr int kBN = 64;   // output columns (P) per block
constexpr int kThreads = (kBM / 4) * (kBN / 4);  // one 4 x 4 micro-tile each

enum Mode { kMxu = 0, kVpu = 1, kWide = 2 };

struct ProbeArgs {
  const float* l;   // (kmax, tb)
  const float* lt;  // (tb, kmax)
  const float* r;   // (kmax, p)
  const float* r2;  // (kmax, 2p)
  float* out;       // (tb, p)
  int kmax, tb, p, grid;
};

// acc[i][c] += (s * a[i]) * b[c] over one contraction row
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b,
                                       float s) {
  const float as[4] = {__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                       __fmul_rn(a.z, s), __fmul_rn(a.w, s)};
  const float bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(as[i], bs[c], acc[i][c]);
}

// Shared memory, in floats, of one block: the L rows read ([KL][kBM]), the
// LT columns of kVpu ([K2][kBM]), the R rows ([KA][kBN]) and R2's second
// half for kWide ([KB][kBN]).
template <int K1, int K2, int MODE>
struct Smem {
  static constexpr int kL = MODE == kVpu ? K1 : K1 + K2;  // L rows read
  static constexpr int kLt = MODE == kVpu ? K2 : 0;        // LT columns
  static constexpr int kR = K1 + K2;  // R rows (R2's left half for kWide)
  static constexpr int kR2 = MODE == kWide ? K1 + K2 : 0;  // R2 right half
  static constexpr int kFloats = (kL + kLt) * kBM + (kR + kR2) * kBN;
};

template <int K1, int K2, int MODE>
__global__ void __launch_bounds__(kThreads)
    kdepth_kernel(const ProbeArgs a) {
  using S = Smem<K1, K2, MODE>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ls = smem;                    // [kL][kBM]
  float* lts = ls + S::kL * kBM;       // [kLt][kBM]
  float* rs = lts + S::kLt * kBM;      // [kR][kBN]
  float* r2s = rs + S::kR * kBN;       // [kR2][kBN]
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int t = threadIdx.x;

  // stage the block's operand slices once
  for (int e = t; e < S::kL * kBM; e += kThreads)
    ls[e] = a.l[(e / kBM) * a.tb + row0 + e % kBM];
  for (int e = t; e < S::kLt * kBM; e += kThreads)
    lts[e] = a.lt[(row0 + e % kBM) * a.kmax + K1 + e / kBM];
  if (MODE == kWide) {
    for (int e = t; e < S::kR * kBN; e += kThreads)
      rs[e] = a.r2[(e / kBN) * 2 * a.p + col0 + e % kBN];
    for (int e = t; e < S::kR2 * kBN; e += kThreads)
      r2s[e] = a.r2[(e / kBN) * 2 * a.p + a.p + col0 + e % kBN];
  } else {
    for (int e = t; e < S::kR * kBN; e += kThreads)
      rs[e] = a.r[(e / kBN) * a.p + col0 + e % kBN];
  }
  __syncthreads();

  const int tx = t % (kBN / 4);  // column group: columns 4 tx .. 4 tx + 3
  const int ty = t / (kBN / 4);  // row group: rows 4 ty .. 4 ty + 3
  const float4* ls4 = reinterpret_cast<const float4*>(ls);
  const float4* lts4 = reinterpret_cast<const float4*>(lts);
  const float4* rs4 = reinterpret_cast<const float4*>(rs);
  const float4* r2s4 = reinterpret_cast<const float4*>(r2s);
  constexpr int kRowF4 = kBM / 4, kColF4 = kBN / 4;

  float o[4][4] = {};
  for (int j = 0; j < a.grid; ++j) {
    // compiler barrier: every step reads its operands from shared memory
    // again, as every TPU grid step reads VMEM. Without it nvcc hoists the
    // loop-invariant loads of all K rows out of the step loop into
    // registers (255 registers and spills from K = 44 on, but a
    // register-resident K = 8), which measures the compiler, not K.
    asm volatile("" ::: "memory");
    const float s = __fadd_rn(1.0f, __fmul_rn(static_cast<float>(j), 1e-9f));
    float dw[4][4] = {}, du[4][4] = {};
    if (MODE == kWide) {
#pragma unroll 4
      for (int k = 0; k < K1 + K2; ++k) {
        const float4 lv = ls4[k * kRowF4 + ty];
        outer4(dw, lv, rs4[k * kColF4 + tx], s);
        outer4(du, lv, r2s4[k * kColF4 + tx], s);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < K1; ++k)
        outer4(dw, ls4[k * kRowF4 + ty], rs4[k * kColF4 + tx], s);
#pragma unroll 4
      for (int k = 0; k < K2; ++k) {
        const float4 lv = MODE == kVpu ? lts4[k * kRowF4 + ty]
                                       : ls4[(K1 + k) * kRowF4 + ty];
        outer4(du, lv, rs4[(K1 + k) * kColF4 + tx], s);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the products by 0.5 and 0.25 are exact: contraction changes
        // nothing in these two lines
        if (K2 > 0)
          o[i][c] += K1 > 0 ? dw[i][c] * 0.5f + du[i][c] * 0.25f
                            : du[i][c] * 0.25f;
        else
          o[i][c] += dw[i][c] * 0.5f;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    reinterpret_cast<float4*>(a.out + static_cast<size_t>(row) * a.p +
                              col0)[tx] =
        make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
}

template <int K1, int K2, int MODE>
cudaError_t launch(const ProbeArgs& a, cudaStream_t s) {
  const int bytes =
      Smem<K1, K2, MODE>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kdepth_kernel<K1, K2, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 blocks(a.p / kBN, a.tb / kBM);
  kdepth_kernel<K1, K2, MODE><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// G = grid steps of the probe variant (k1, k2, mode) on `stream` of
// `device`; mode 0: both contractions read l, 1: the second reads lt, 2:
// one contraction against the block-diagonal r2 (k1 + k2 rows). Every
// pointer is device memory, row-major: l (kmax, tb), lt (tb, kmax), r
// (kmax, p), r2 (kmax, 2p), out (tb, p). tb must be a multiple of 32, p of
// 64, k1 + k2 <= kmax; the variants are those of tools/mxu_kdepth.py.
// Returns cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised.
int qfa_kdepth_f32(const float* l, const float* lt, const float* r,
                   const float* r2, float* out, int kmax, int tb, int p,
                   int k1, int k2, int mode, int grid, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tb <= 0 || p <= 0 || tb % kBM != 0 || p % kBN != 0 || grid < 0 ||
      k1 < 0 || k2 < 0 || k1 + k2 > kmax)
    return static_cast<int>(cudaErrorInvalidValue);
  const ProbeArgs a{l, lt, r, r2, out, kmax, tb, p, grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (k1 * 1000 + k2) * 10 + mode;
  switch (key) {
    case (36 * 1000 + 8) * 10 + kMxu: err = launch<36, 8, kMxu>(a, s); break;
    case (8 * 1000 + 0) * 10 + kMxu: err = launch<8, 0, kMxu>(a, s); break;
    case (44 * 1000 + 0) * 10 + kMxu: err = launch<44, 0, kMxu>(a, s); break;
    case (64 * 1000 + 0) * 10 + kMxu: err = launch<64, 0, kMxu>(a, s); break;
    case (128 * 1000 + 0) * 10 + kMxu: err = launch<128, 0, kMxu>(a, s); break;
    case (0 * 1000 + 8) * 10 + kVpu: err = launch<0, 8, kVpu>(a, s); break;
    case (36 * 1000 + 8) * 10 + kVpu: err = launch<36, 8, kVpu>(a, s); break;
    case (36 * 1000 + 8) * 10 + kWide: err = launch<36, 8, kWide>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
