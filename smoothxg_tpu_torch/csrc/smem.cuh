// smem.cuh — a kernel's opt-in to more dynamic shared memory than a block
// gets by default.
#pragma once

#include <cuda_runtime.h>

// Let `fn` launch with `smem` bytes of dynamic shared memory.  Without
// asking, a block gets 48 KB of static and dynamic shared memory together,
// so a launch whose dynamic bytes and the kernel's own __shared__ buffers
// (cudaFuncGetAttributes' sharedSizeBytes) pass 48 KB first raises the
// kernel's cap to `smem`; a launch of a few bytes under 48 KB of dynamic
// memory needs it too.  Returns the CUDA error of either call.
template <typename F>
inline cudaError_t opt_in_smem(F fn, size_t smem) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess || smem + attr.sharedSizeBytes <= 48 * 1024)
        return err;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}
