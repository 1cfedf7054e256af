// guard_alloc.cu — a device allocator for PyTorch
// (torch.cuda.memory.CUDAPluggableAllocator) that checks the port's kernels
// for what compute-sanitizer's memcheck and initcheck look for, where that
// tool cannot run: every allocation gets guard bands of kGuard bytes before
// and after it, and its own bytes start as a chosen poison byte.
//
// * A write past either end of an allocation changes its guard band; the
//   bands are checked when the allocation is freed and by guard_check()
//   over every live one, and each damaged band counts as a violation.
// * A read of bytes the program never wrote (an output or scratch buffer
//   the kernel reads before writing) or of bytes past an input's end sees
//   the poison or the band: tools/sanitize_drive.py runs every
//   launch under two poisons, and a result that depends on them differs
//   from the plain version under one of them.
// * guard_poison_smem fills the shared memory of every SM with the poison,
//   so that a kernel launched next that reads shared memory it has not
//   written sees it (the card does not clear shared memory between the
//   kernels of a context, though nothing promises that a block lands on
//   the poisoned bytes).
//
// The allocator waits for the device before it checks or frees, and it
// keeps no cache: it is a test harness, not for timing.  Plain C interface,
// built by nvcc alone (tools/sanitize.py).
#include <cuda_runtime.h>

#include <sys/types.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kGuard = 4096;          // bytes of each band (256-aligned)

struct Block {
    char* base;                          // the cudaMalloc'd bytes
    size_t size;                         // the caller's
    unsigned char band;                  // the bands' byte
};

std::mutex mu;
std::unordered_map<void*, Block> live;
int poison = 0xa5;
long long violations = 0, allocations = 0;
char first[512] = "";

unsigned char band_of(int p) { return (unsigned char)(p ^ 0x3c); }

// the bands of `b` intact; records a violation otherwise (mu held)
bool check_block(void* ptr, const Block& b) {
    std::vector<unsigned char> host(2 * kGuard);
    if (cudaMemcpy(host.data(), b.base, kGuard, cudaMemcpyDeviceToHost) !=
            cudaSuccess ||
        cudaMemcpy(host.data() + kGuard, b.base + kGuard + b.size, kGuard,
                   cudaMemcpyDeviceToHost) != cudaSuccess)
        return false;
    for (size_t i = 0; i < 2 * kGuard; ++i) {
        if (host[i] == b.band) continue;
        const bool head = i < kGuard;
        if (!violations)
            std::snprintf(first, sizeof first,
                          "allocation %p of %zu bytes: byte %lld %s it "
                          "changed (0x%02x, band 0x%02x)",
                          ptr, b.size,
                          head ? (long long)i - (long long)kGuard
                               : (long long)(i - kGuard),
                          head ? "before" : "past the end of", host[i],
                          b.band);
        ++violations;
        return false;
    }
    return true;
}

__global__ void poison_smem_kernel(int byte, int words) {
    extern __shared__ uint32_t smem[];
    const uint32_t w = 0x01010101u * (uint32_t)(byte & 0xff);
    for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = w;
}

}  // namespace

extern "C" {

void* guard_malloc(ssize_t size, int device, cudaStream_t) {
    std::lock_guard<std::mutex> lock(mu);
    int prev = 0;
    cudaGetDevice(&prev);
    cudaSetDevice(device);
    char* base = nullptr;
    const size_t n = (size_t)size;
    void* ptr = nullptr;
    if (cudaMalloc(&base, n + 2 * kGuard) == cudaSuccess) {
        const unsigned char band = band_of(poison);
        cudaMemset(base, band, kGuard);
        cudaMemset(base + kGuard, poison, n);
        cudaMemset(base + kGuard + n, band, kGuard);
        cudaDeviceSynchronize();
        ptr = base + kGuard;
        live[ptr] = {base, n, band};
        ++allocations;
    }
    cudaSetDevice(prev);
    return ptr;
}

void guard_free(void* ptr, ssize_t, int device, cudaStream_t) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = live.find(ptr);
    if (it == live.end()) return;
    int prev = 0;
    cudaGetDevice(&prev);
    cudaSetDevice(device);
    cudaDeviceSynchronize();             // its last kernels have run
    check_block(ptr, it->second);
    cudaFree(it->second.base);
    live.erase(it);
    cudaSetDevice(prev);
}

// the poison byte of allocations made from now on
void guard_set_poison(int byte) {
    std::lock_guard<std::mutex> lock(mu);
    poison = byte & 0xff;
}

// check every live allocation's bands (after a device-wide wait); returns
// the violations counted so far
long long guard_check(void) {
    std::lock_guard<std::mutex> lock(mu);
    cudaDeviceSynchronize();
    for (auto& kv : live) check_block(kv.first, kv.second);
    return violations;
}

long long guard_allocations(void) { return allocations; }

// the first violation, or ""
const char* guard_first(void) { return first; }

// fill the shared memory of every SM of the current device with `byte`:
// blocks of the most shared memory a block may have, several an SM
int guard_poison_smem(int byte) {
    int dev = 0, sms = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(poison_smem_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    poison_smem_kernel<<<4 * sms, 1024, optin>>>(byte, optin / 4);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    return (int)err;
}

}  // extern "C"
