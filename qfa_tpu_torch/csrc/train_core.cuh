// Cross-block pieces shared by the training kernels (epoch.cu, step.cu):
// the arrival counter that finds the last block of a launch (so a
// cross-block sum runs once, in a fixed order, with no float atomics),
// programmatic dependent launch, and the launch helper that asks for it.
// Included inside no namespace of its own: each kernel source is one
// translation unit and takes these as its own internal functions.
#pragma once

#include <cuda_runtime.h>

namespace {

// True in every thread of the block that arrives last at `counter` of
// `arrivals`; that block resets the counter. Every block calls it after
// its last global write: the fence makes those writes visible first.
__device__ __forceinline__ bool last_to_arrive(int* counter, int arrivals,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == arrivals - 1;
    if (last) *counter = 0;  // no block of this launch reads it again
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// Programmatic dependent launch (Hopper): each kernel lets the next one
// of the stream start as soon as all its own blocks are running, and the
// next one issues the loads that do not depend on it (the planes, the
// permutation, the parameters it only reads) before it waits here for
// its completion, so the launch gap and the previous kernel's tail
// overlap useful work.
__device__ __forceinline__ void pdl_launch_dependents() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}
__device__ __forceinline__ void pdl_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// Launch a kernel that, with `early`, may start before the previous
// kernel of the stream ends (it waits in pdl_wait before reading that
// one's results); without, it starts when that one has ended.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   cudaStream_t s, bool early, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
