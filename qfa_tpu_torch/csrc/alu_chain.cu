// ALU throughput calibration kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel bench.py::calibrate_vpu's `kernel` (bench.py:410,
// Pallas; pl.pallas_call at bench.py:437). Each element of an (R, C) f32
// tile starts 4 independent chains at x * (1 + 0.01 k), k = 0..3, runs
// n_iters iterations of 32 unrolled reps of one op on each chain, and
// writes ((x0 + x1) + x2) + x3 (JAX's sum(xs), left to right). The ops are
// written as in JAX:
//   fma  x * 1.0000001f + 1e-7f   (nvcc contracts it into one FFMA)
//   exp  expf(-x)
//   log  logf(x + 1.5f)
//   div  1.0f / (x + 1.5f)
// Timing two iteration counts and differencing cancels the launch and the
// tile's read and write, so the slope is the ALU rate of the op.
//
// Design: one thread per element, the four chains in registers (4-way
// instruction-level parallelism hides the FFMA and MUFU latencies), the
// op a template parameter (four instantiations; the C entry switches on
// the op id as the JAX kernel's lax.switch did on its SMEM selector, which
// there only saved TPU compiles). The iteration count is a run-time
// argument, so one build serves every count.
//
// What bounds it on an H100: the FP32 pipes for fma (2 operations per
// FFMA, 67 TFLOP/s published at 700 W), the MUFU (16 per SM per clock)
// and the FP32 pipes for the IEEE expf, logf and division sequences. At
// (256, 1024) the 262,144 threads fill the card's 132 x 2048 resident
// threads in one wave as long as the kernel stays at 32 registers or fewer
// per thread (ptxas reports it in the build log).
//
// Build without -use_fast_math: the rates measured are those of the
// port's own kernels, which use IEEE expf, logf and division, not __expf
// or __fdividef.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReps = 32;  // unrolled reps per chain per iteration

enum Op { kFma = 0, kExp = 1, kLog = 2, kDiv = 3 };

template <int OP>
__device__ __forceinline__ float step(float x) {
  if constexpr (OP == kFma) {
    return x * 1.0000001f + 1e-7f;
  } else if constexpr (OP == kExp) {
    return expf(-x);
  } else if constexpr (OP == kLog) {
    return logf(x + 1.5f);
  } else {
    return 1.0f / (x + 1.5f);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
    alu_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n, int n_iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  // the chains' start factors are JAX's 1.0 + 0.01 * k, rounded to f32
  float x0 = v * static_cast<float>(1.0 + 0.01 * 0);
  float x1 = v * static_cast<float>(1.0 + 0.01 * 1);
  float x2 = v * static_cast<float>(1.0 + 0.01 * 2);
  float x3 = v * static_cast<float>(1.0 + 0.01 * 3);
  for (int it = 0; it < n_iters; ++it) {
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
      x0 = step<OP>(x0);
      x1 = step<OP>(x1);
      x2 = step<OP>(x2);
      x3 = step<OP>(x3);
    }
  }
  out[i] = ((x0 + x1) + x2) + x3;
}

template <int OP>
cudaError_t launch(const float* x, float* out, int n, int n_iters,
                   cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  alu_chain_kernel<OP><<<blocks, kThreads, 0, s>>>(x, out, n, n_iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// n_iters iterations of the op's chains over the n floats at x, written
// to out (both device memory) on `stream` of `device`. op: 0 fma, 1 exp,
// 2 log, 3 div. Returns cudaGetLastError() after the launch (0 =
// launched); nothing is synchronised.
int qfa_alu_chain_f32(const float* x, float* out, int n, int n_iters, int op,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || n_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kFma: err = launch<kFma>(x, out, n, n_iters, s); break;
    case kExp: err = launch<kExp>(x, out, n, n_iters, s); break;
    case kLog: err = launch<kLog>(x, out, n, n_iters, s); break;
    case kDiv: err = launch<kDiv>(x, out, n, n_iters, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
