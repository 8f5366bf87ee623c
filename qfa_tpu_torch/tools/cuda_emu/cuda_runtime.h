// CPU stand-in for the parts of the CUDA runtime and device language that
// qfa_tpu_torch/csrc/epoch.cu, predict.cu, step.cu and kdepth.cu use, so that g++
// compiles the kernel sources themselves for the CPU
// (qfa_tpu_torch/tools/emulate.py).
// One std::thread per CUDA thread; the blocks of a launch run one after
// another, so __shared__ becomes a static shared by the block's threads;
// __syncthreads is a barrier of the block, a warp shuffle two barriers of
// its warp. Dynamic shared memory is filled with NaN before each block,
// and an asynchronous copy (cp.async) lands only when its thread waits for
// its group, so a read of a stage before its wait and barrier sees NaN or
// stale data. The warp's m16n8k8 TF32 tensor-core product follows the PTX
// ISA's fragment layout. Nothing here models a resource limit (registers, shared
// memory, block residency): the occupancy query answers 1 block on each
// of 2 SMs, so a persistent grid walks several tiles per block.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
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
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1,
          cudaErrorInvalidConfiguration = 9;
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == 0 ? "no error" : "emulated CUDA error";
}
typedef void* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
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
inline float __shfl_xor_sync(unsigned, float x, int o) {
  g_slot[threadIdx.x] = x;
  emu_warp_sync();
  float y = g_slot[threadIdx.x ^ o];
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
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
// dynamic shared memory of the running block
inline std::vector<float> g_dyn_smem;
inline float* emu_dynamic_smem() { return g_dyn_smem.data(); }
// cp.async: a thread's copies queue in its open group; commit closes the
// group; wait(n) performs the thread's oldest groups until n are left
struct EmuCopy { void* dst; const void* src; int bytes; };
inline thread_local std::vector<EmuCopy> g_open_group;
inline thread_local std::deque<std::vector<EmuCopy>> g_groups;
inline void emu_cp_async(void* dst, const void* src, int bytes) {
  g_open_group.push_back({dst, src, bytes});
}
inline void emu_cp_async_commit() {
  g_groups.push_back(std::move(g_open_group));
  g_open_group.clear();
}
inline void emu_cp_async_wait(int n) {
  while (static_cast<int>(g_groups.size()) > n) {
    for (const EmuCopy& c : g_groups.front()) std::memcpy(c.dst, c.src, c.bytes);
    g_groups.pop_front();
  }
}
template <class Fn>
void emu_launch(dim3 g, dim3 b, Fn fn, size_t smem_bytes = 0) {
  gridDim.x = g.x; gridDim.y = g.y; gridDim.z = 1;
  blockDim.x = b.x;
  for (unsigned y = 0; y < g.y; ++y)
    for (unsigned x = 0; x < g.x; ++x) {
      blockIdx.x = x; blockIdx.y = y;
      g_dyn_smem.assign(smem_bytes / sizeof(float),
                        std::numeric_limits<float>::quiet_NaN());
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
  emu_launch(c->gridDim, c->blockDim, [&] { k(a...); }, c->dynamicSmemBytes);
  return 0;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return 0;
}
// every warp of the block reaches the same __syncwarp calls, so a block
// barrier stands in for the warp barrier
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += A B, by the
// calling warp: every lane deposits its fragments (two slot sets used in
// turn, so one warp barrier per product), then computes its own four
// outputs from all 32 lanes' fragments, in the PTX ISA's layout (g = lane /
// 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g, 2t and 2t + 1), d2,
// d3 (g + 8, 2t and 2t + 1). The tensor cores read the 19 TF32 bits of an
// operand; a product of two is exact in float, summed here in k order.
struct EmuMmaSlot { uint32_t a[4], b[2]; };
inline EmuMmaSlot g_mma[2][1024];
inline thread_local int g_mma_turn = 0;
inline void emu_mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                 uint32_t b0, uint32_t b1) {
  EmuMmaSlot* slots = g_mma[g_mma_turn];
  g_mma_turn ^= 1;
  slots[threadIdx.x] = {{a[0], a[1], a[2], a[3]}, {b0, b1}};
  emu_warp_sync();
  const EmuMmaSlot* w = slots + (threadIdx.x & ~31u);
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto tf32 = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  for (unsigned e = 0; e < 4; ++e) {
    const unsigned row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = d[e];
    for (unsigned k = 0; k < 8; ++k)
      acc += tf32(w[(row & 7) * 4 + (k & 3)].a[(row >> 3) + 2 * (k >> 2)]) *
             tf32(w[col * 4 + (k & 3)].b[k >> 2]);
    d[e] = acc;
  }
}
