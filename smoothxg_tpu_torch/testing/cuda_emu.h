// cuda_emu.h — just enough of the CUDA runtime to run the port's
// whole-block POA kernels on the CPU, for testing their logic where there
// is no GPU (smoothxg_tpu_torch/testing/cuda_emu.py compiles a kernel
// source against it with g++ -std=c++20).
//
// A thread block is `blockDim.x` std::threads; thread blocks run one after
// another, so `__shared__` variables are plain statics.  __syncthreads is a
// std::barrier over the block, each warp has its own barrier for
// __syncwarp, and a warp shuffle or ballot is a write to the warp's
// exchange buffer between two waits on that barrier.  Every lane of a warp
// must take part in its collectives, as on the card.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
    unsigned x = 1, y = 1, z = 1;
};

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;

inline thread_local dim3 threadIdx, blockIdx, blockDim;

template <typename F>
inline int cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(int) { return "no error"; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }

namespace emu {

struct Warp {
    std::barrier<> bar{32};
    long long buf[32];
};

inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<Warp>> warps;
inline std::vector<int8_t> dyn_smem;

inline Warp& warp() { return *warps[threadIdx.x >> 5]; }

template <typename T>
inline T exchange(T v, int src) {
    Warp& w = warp();
    const int lane = threadIdx.x & 31;
    w.buf[lane] = (long long)v;
    w.bar.arrive_and_wait();
    const T r = (T)w.buf[src];
    w.bar.arrive_and_wait();
    return r;
}

// run `kernel(args...)` over `grid` thread blocks of `block` threads
template <typename K, typename... A>
void launch(unsigned grid, unsigned block, size_t smem, cudaStream_t,
            K kernel, A... args) {
    dyn_smem.assign(smem + 16, 0);
    for (unsigned b = 0; b < grid; ++b) {
        block_bar = std::make_unique<std::barrier<>>(block);
        warps.clear();
        for (unsigned w = 0; w < (block + 31) / 32; ++w)
            warps.push_back(std::make_unique<Warp>());
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block; ++t)
            ts.emplace_back([=] {
                threadIdx.x = t;
                blockIdx.x = b;
                blockDim.x = block;
                kernel(args...);
            });
        for (auto& t : ts) t.join();
    }
}

}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    emu::warp().bar.arrive_and_wait();
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
    return emu::exchange(v, src & 31);
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
    const int lane = threadIdx.x & 31;
    return emu::exchange(v, lane >= (int)d ? lane - (int)d : lane);
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, unsigned d) {
    const int lane = threadIdx.x & 31;
    return emu::exchange(v, lane + (int)d < 32 ? lane + (int)d : lane);
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
    return emu::exchange(v, (threadIdx.x & 31) ^ m);
}
inline unsigned __ballot_sync(unsigned, int pred) {
    emu::Warp& w = emu::warp();
    const int lane = threadIdx.x & 31;
    w.buf[lane] = pred ? 1 : 0;
    w.bar.arrive_and_wait();
    unsigned r = 0;
    for (int i = 0; i < 32; ++i)
        if (w.buf[i]) r |= 1u << i;
    w.bar.arrive_and_wait();
    return r;
}
