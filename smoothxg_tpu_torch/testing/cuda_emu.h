// cuda_emu.h — just enough of the CUDA runtime (and cuda_pipeline.h's
// asynchronous copies) to run the port's POA
// kernels, its split-stage, SGD and autocorrelation kernels and its probes
// on the CPU, for testing their
// logic where there is no GPU (smoothxg_tpu_torch/testing/cuda_emu.py
// compiles a kernel source against it with g++ -std=c++20).
//
// A thread block is `blockDim.x` std::threads; thread blocks run one after
// another, so `__shared__` variables are plain statics, except a cluster
// launch's (cudaLaunchKernelEx), whose blocks run at once, each with its
// own dynamic shared memory, which the others reach through
// cooperative_groups::cluster_group::map_shared_rank.  __syncthreads is a
// std::barrier over the block, each warp has its own barrier for
// __syncwarp, and a warp shuffle or ballot is a write to the warp's
// exchange buffer between two waits on that barrier.  Every lane of a warp
// must take part in its collectives, as on the card.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
    unsigned x = 1, y = 1, z = 1;
};
struct alignas(16) int4 {
    int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) uint2 {
    unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct alignas(8) float2 {
    float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaFuncAttributeNonPortableClusterSizeAllowed = 12;
constexpr int cudaDevAttrMultiProcessorCount = 16;
constexpr int cudaDevAttrMaxSharedMemoryPerBlockOptin = 97;
constexpr int cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81;

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
// the emulated device: SM count and shared memory limits (an H100's by
// default; the test driver sets them), the dynamic shared memory the last
// cudaFuncSetAttribute opted in to (0: none), the static __shared__ bytes
// taken for every kernel (cudaFuncGetAttributes reports them: a launch
// whose dynamic bytes pass 48 KB with them needs the opt-in, as on the
// card), and the pending launch error
inline int sms = 132, smem_block = 232448, smem_sm = 233472;
inline int opt_in = 0;
inline int static_smem = 512;
// clusters past the portable 8 blocks, once a kernel allowed them (the
// card's limit is then 16)
inline bool nonportable = false;
inline int error = cudaSuccess;
}  // namespace emu

template <typename F>
inline int cudaFuncSetAttribute(F, int attr, int value) {
    if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) {
        if (value > emu::smem_block) return cudaErrorInvalidValue;
        emu::opt_in = value;
    }
    if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed)
        emu::nonportable = value != 0;
    return cudaSuccess;
}
struct cudaFuncAttributes {
    size_t sharedSizeBytes;
};
template <typename F>
inline int cudaFuncGetAttributes(cudaFuncAttributes* attr, F) {
    attr->sharedSizeBytes = (size_t)emu::static_smem;
    return cudaSuccess;
}
// blocks of `block` threads and `smem` dynamic bytes an SM holds, by its
// threads and shared memory (the card also counts registers)
template <typename F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int block,
                                                         size_t smem) {
    const int by_smem = (int)(emu::smem_sm / (smem + 1024));
    const int by_threads = 2048 / block;
    *n = by_smem < by_threads ? by_smem : by_threads;
    return cudaSuccess;
}
inline int cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
    *v = attr == cudaDevAttrMultiProcessorCount ? emu::sms
       : attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? emu::smem_block
       : attr == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? emu::smem_sm
       : 0;
    return *v ? cudaSuccess : cudaErrorInvalidValue;
}
// stream-ordered memset: the launches before it have run
inline int cudaMemsetAsync(void* p, int value, size_t n, cudaStream_t = nullptr) {
    std::memset(p, value, n);
    return cudaSuccess;
}
inline int cudaGetLastError() {
    const int e = emu::error;
    emu::error = cudaSuccess;
    return e;
}
inline const char* cudaGetErrorString(int) { return "no error"; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
    return std::atomic_ref<int>(*p).fetch_add(v);
}
inline void __threadfence_block() {
    std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void __threadfence() {
    std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void __trap() { std::abort(); }
// a spin-wait's pause: the emulated threads share few cores
#define SPIN_PAUSE() std::this_thread::yield()
inline unsigned atomicOr(unsigned* p, unsigned v) {
    return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
// the funnel shift of the autocorrelation kernel
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
    const unsigned long long v = ((unsigned long long)hi << 32) | lo;
    return (unsigned)(v >> (shift & 31));
}
inline unsigned __umulhi(unsigned a, unsigned b) {
    return (unsigned)(((unsigned long long)a * b) >> 32);
}
// round-to-nearest float arithmetic: plain operations on the host (the
// emulation builds without FMA contraction)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __float_as_int(float v) {
    int r;
    std::memcpy(&r, &v, 4);
    return r;
}
inline float __int_as_float(int v) {
    float r;
    std::memcpy(&r, &v, 4);
    return r;
}
// cache-operator loads and stores: plain accesses on the host
template <typename T>
inline T __ldcg(const T* p) { return *p; }
template <typename T>
inline void __stcg(T* p, T v) { *p = v; }

// asynchronous copies (cuda_pipeline.h): the source is read when the copy
// is issued and the destination written only when __pipeline_wait_prior
// retires its group, so a read of the destination before the wait sees
// the old bytes, as it may on the card
namespace emu {
struct Copy {
    void* dst;
    std::vector<char> bytes;
};
inline thread_local std::vector<Copy> open_group;
inline thread_local std::vector<std::vector<Copy>> groups;
}  // namespace emu
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
    const char* p = static_cast<const char*>(src);
    emu::open_group.push_back({dst, std::vector<char>(p, p + n)});
}
inline void __pipeline_commit() {
    emu::groups.push_back(std::move(emu::open_group));
    emu::open_group.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
    while (emu::groups.size() > prior) {
        for (auto& c : emu::groups.front())
            std::memcpy(c.dst, c.bytes.data(), c.bytes.size());
        emu::groups.erase(emu::groups.begin());
    }
}

namespace emu {

struct Warp {
    std::barrier<> bar{32};
    long long buf[32];
};

// a thread block's barrier, warps and dynamic shared memory; each thread
// points at its own block's
struct Block {
    std::unique_ptr<std::barrier<>> bar;
    std::vector<std::unique_ptr<Warp>> warps;
    int8_t* smem = nullptr;

    void reset(unsigned threads, int8_t* mem) {
        bar = std::make_unique<std::barrier<>>(threads);
        warps.clear();
        for (unsigned w = 0; w < (threads + 31) / 32; ++w)
            warps.push_back(std::make_unique<Warp>());
        smem = mem;
    }
};
// a cluster's blocks, run at once, and its barrier
struct Cluster {
    std::unique_ptr<std::barrier<>> bar;
    std::vector<Block>* blocks = nullptr;
};
inline thread_local Block* self = nullptr;
inline thread_local Cluster* cluster = nullptr;
inline thread_local unsigned cluster_rank = 0;

inline Warp& warp() { return *self->warps[threadIdx.x >> 5]; }
inline void* block_smem() { return self->smem; }

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

inline bool refused(unsigned block, size_t smem) {
    if (smem > (size_t)smem_block ||
        (smem + static_smem > 48 * 1024 && smem > (size_t)opt_in) ||
        block > 1024) {
        error = cudaErrorInvalidValue;
        return true;
    }
    return false;
}

// run `kernel(args...)` over `grid` thread blocks of `block` threads, one
// block after another; a launch the card would refuse (too much dynamic
// shared memory, or more than 48 KB with the static bytes without opting
// in) does not run and
// leaves an error for cudaGetLastError.  Shared memory starts as garbage,
// as on the card, and is a heap block of exactly the launch's bytes, so
// that AddressSanitizer reports a read or write past it.
inline std::unique_ptr<int8_t[]> shared_bytes(size_t smem) {
    std::unique_ptr<int8_t[]> mem(new int8_t[smem]);
    std::memset(mem.get(), 0x5a, smem);
    return mem;
}

template <typename K, typename... A>
void launch(unsigned grid, unsigned block, size_t smem, cudaStream_t,
            K kernel, A... args) {
    if (refused(block, smem)) return;
    const auto mem = shared_bytes(smem);
    Block blk;
    for (unsigned b = 0; b < grid; ++b) {
        blk.reset(block, mem.get());
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block; ++t)
            ts.emplace_back([=, &blk] {
                threadIdx.x = t;
                blockIdx.x = b;
                blockDim.x = block;
                gridDim.x = grid;
                self = &blk;
                kernel(args...);
            });
        for (auto& t : ts) t.join();
    }
}

// the same over clusters of `csize` blocks: a cluster's blocks run at
// once, each with its own dynamic shared memory (a kernel launched so
// keeps its shared memory dynamic: `__shared__` statics are one for all
// blocks here), and clusters one after another
template <typename K, typename... A>
void launch_cluster(unsigned grid, unsigned block, size_t smem,
                    unsigned csize, K kernel, A... args) {
    if (refused(block, smem) || csize == 0 || grid % csize != 0 ||
        csize > (nonportable ? 16u : 8u)) {
        error = cudaErrorInvalidValue;
        return;
    }
    for (unsigned c = 0; c < grid / csize; ++c) {
        std::vector<std::unique_ptr<int8_t[]>> mem(csize);
        std::vector<Block> blocks(csize);
        for (unsigned r = 0; r < csize; ++r) {
            mem[r] = shared_bytes(smem);
            blocks[r].reset(block, mem[r].get());
        }
        Cluster clu;
        clu.bar = std::make_unique<std::barrier<>>(csize * block);
        clu.blocks = &blocks;
        std::vector<std::thread> ts;
        for (unsigned r = 0; r < csize; ++r)
            for (unsigned t = 0; t < block; ++t)
                ts.emplace_back([=, &blocks, &clu] {
                    threadIdx.x = t;
                    blockIdx.x = c * csize + r;
                    blockDim.x = block;
                    gridDim.x = grid;
                    self = &blocks[r];
                    cluster = &clu;
                    cluster_rank = r;
                    kernel(args...);
                });
        for (auto& t : ts) t.join();
    }
}

}  // namespace emu

// cudaLaunchKernelEx with a cluster dimension (the one attribute emulated)
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
    struct {
        unsigned x, y, z;
    } clusterDim;
};
struct cudaLaunchAttribute {
    cudaLaunchAttributeID id;
    cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
    dim3 gridDim;
    dim3 blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
template <typename... E, typename... A>
inline int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                              void (*kernel)(E...), A&&... args) {
    unsigned csize = 1;
    for (unsigned i = 0; i < cfg->numAttrs; ++i)
        if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
            csize = cfg->attrs[i].val.clusterDim.x;
    emu::launch_cluster(cfg->gridDim.x, cfg->blockDim.x,
                        cfg->dynamicSmemBytes, csize, kernel, E(args)...);
    const int e = emu::error;
    emu::error = cudaSuccess;
    return e;
}

// clusters of the launch's shape the emulated card holds at once: its SMs'
// blocks by threads and shared memory, a cluster's blocks on as many SMs
template <typename F>
inline int cudaOccupancyMaxActiveClusters(int* n, F kernel,
                                          const cudaLaunchConfig_t* cfg) {
    unsigned csize = 1;
    for (unsigned i = 0; i < cfg->numAttrs; ++i)
        if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
            csize = cfg->attrs[i].val.clusterDim.x;
    if (emu::refused(cfg->blockDim.x, cfg->dynamicSmemBytes) ||
        csize > (emu::nonportable ? 16u : 8u)) {
        emu::error = cudaSuccess;
        *n = 0;
        return cudaSuccess;
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, (int)cfg->blockDim.x, cfg->dynamicSmemBytes);
    *n = emu::sms >= (int)csize ? per_sm * (emu::sms / (int)csize) : 0;
    return cudaSuccess;
}

// cooperative_groups' cluster: its barrier, the block's rank, and another
// block's shared memory at the same offset
namespace cooperative_groups {
struct cluster_group {
    void sync() const { emu::cluster->bar->arrive_and_wait(); }
    unsigned block_rank() const { return emu::cluster_rank; }
    unsigned num_blocks() const {
        return (unsigned)emu::cluster->blocks->size();
    }
    template <typename T>
    T* map_shared_rank(T* p, unsigned rank) const {
        const std::ptrdiff_t off =
            reinterpret_cast<int8_t*>(p) - emu::self->smem;
        return reinterpret_cast<T*>((*emu::cluster->blocks)[rank].smem +
                                    off);
    }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

inline void __syncthreads() { emu::self->bar->arrive_and_wait(); }
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
// the warp's minimum and maximum (the card's are for 32-bit integers)
namespace emu {
template <typename T, typename Op>
inline T reduce_warp(T v, Op op) {
    emu::Warp& w = emu::warp();
    const int lane = threadIdx.x & 31;
    w.buf[lane] = (long long)v;
    w.bar.arrive_and_wait();
    T r = (T)w.buf[0];
    for (int i = 1; i < 32; ++i) r = op(r, (T)w.buf[i]);
    w.bar.arrive_and_wait();
    return r;
}
}  // namespace emu
template <typename T>
inline T __reduce_min_sync(unsigned, T v) {
    return emu::reduce_warp(v, [](T a, T b) { return b < a ? b : a; });
}
template <typename T>
inline T __reduce_max_sync(unsigned, T v) {
    return emu::reduce_warp(v, [](T a, T b) { return b > a ? b : a; });
}
template <typename T>
inline T __reduce_add_sync(unsigned, T v) {
    emu::Warp& w = emu::warp();
    const int lane = threadIdx.x & 31;
    w.buf[lane] = (long long)v;
    w.bar.arrive_and_wait();
    T r = 0;
    for (int i = 0; i < 32; ++i) r += (T)w.buf[i];
    w.bar.arrive_and_wait();
    return r;
}
