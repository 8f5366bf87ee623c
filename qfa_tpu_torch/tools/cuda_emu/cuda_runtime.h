// CPU stand-in for the parts of the CUDA runtime and device language that
// qfa_tpu_torch/csrc/epoch.cu uses, so that g++ compiles the kernel source
// itself for the CPU (qfa_tpu_torch/tools/emulate.py). One std::thread per
// CUDA thread; the blocks of a launch run one after another, so
// __shared__ becomes a static shared by the block's threads;
// __syncthreads is a barrier of the block, a warp shuffle two barriers of
// its warp. Nothing here models a resource limit (registers, shared
// memory, block residency).
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct uint3s { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3s threadIdx;
inline uint3s blockIdx, gridDim, blockDim;
struct float4 { float x, y, z, w; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline std::barrier<>* g_bar = nullptr;
inline std::vector<std::barrier<>*> g_warp_bar;  // one per warp
inline float g_slot[1024];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void emu_warp_sync() { g_warp_bar[threadIdx.x >> 5]->arrive_and_wait(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float __shfl_down_sync(unsigned, float x, int o) {
  g_slot[threadIdx.x] = x;
  emu_warp_sync();
  const unsigned lane = threadIdx.x & 31;
  float y = lane + o < 32 ? g_slot[threadIdx.x + o] : x;
  emu_warp_sync();
  return y;
}
inline float __shfl_sync(unsigned, float x, int src) {
  g_slot[threadIdx.x] = x;
  emu_warp_sync();
  float y = g_slot[(threadIdx.x & ~31u) + src];
  emu_warp_sync();
  return y;
}
// correctly rounded single operations (never contracted)
inline float __fadd_rn(float x, float y) { return x + y; }
inline float __fsub_rn(float x, float y) { return x - y; }
inline float __fmul_rn(float x, float y) { return x * y; }
inline float __fdiv_rn(float x, float y) { return x / y; }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
template <class Fn>
void emu_launch(dim3 g, dim3 b, Fn fn) {
  gridDim.x = g.x; gridDim.y = g.y; gridDim.z = 1;
  blockDim.x = b.x;
  for (unsigned y = 0; y < g.y; ++y)
    for (unsigned x = 0; x < g.x; ++x) {
      blockIdx.x = x; blockIdx.y = y;
      std::barrier<> bar(b.x);
      g_bar = &bar;
      std::vector<std::barrier<>*> wbars;
      for (unsigned w = 0; w * 32 < b.x; ++w)
        wbars.push_back(new std::barrier<>(b.x - w * 32 < 32 ? b.x - w * 32 : 32));
      g_warp_bar = wbars;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < b.x; ++t)
        ts.emplace_back([&, t] {
          threadIdx.x = t;
          fn();
          bar.arrive_and_drop();
          wbars[t >> 5]->arrive_and_drop();
        });
      for (auto& th : ts) th.join();
      for (auto* w : wbars) delete w;
    }
}
enum cudaLaunchAttributeID { cudaLaunchAttributeProgrammaticStreamSerialization = 1 };
struct cudaLaunchAttributeValue { int programmaticStreamSerializationAllowed; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t { dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs; };
template <class... KA, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(KA...), A... a) {
  emu_launch(c->gridDim, c->blockDim, [&] { k(a...); });
  return 0;
}
// every warp of the block reaches the same __syncwarp calls, so a block
// barrier stands in for the warp barrier
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
