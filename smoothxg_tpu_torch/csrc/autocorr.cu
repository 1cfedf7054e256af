// autocorr.cu — match counts of the batched autocorrelation screen on
// Hopper (sm_90a).
//
// Replaces the jitted XLA function smoothxg_tpu/ops/autocorr.py:_counts_fn
// (:74), the device half of `repeat_batch`: for each row b of a (B, Lpad)
// uint8 batch and each lag g of a (G,) grid, the number of positions p with
// p + lag_g < lens[b] and rows[b, p] == rows[b, p + lag_g] (the XLA
// function's roll by -lag, compare and mask: the mask keeps the roll from
// ever wrapping).  Bytes are arbitrary symbols: N and lower case count as
// their own.  The counts are exact int32; the host turns them into
// correlations and z scores in float64 (ops/autocorr.py:repeat_batch).
// Lengths are clipped to [0, Lpad]; a negative lag counts 0 (the XLA
// roll would wrap it; the port's grids never hold one).
//
// Design: a thread block takes one row and a chunk of 32 lags, a warp one
// lag at a time.  The row's words are staged into shared memory once a
// block (or, for rows past the shared memory a block may opt in to, read
// through L2 from device memory).  A lane compares 4 bytes at a time:
// word k of the row against the 4 bytes at 4 k + lag, which
// __funnelshift_r cuts out of words k + lag / 4 and k + lag / 4 + 1;
// __vcmpeq4 marks the equal bytes, the last word of the lag's window is
// masked at lens[b] - lag, and __popc counts 8 bits a match.  The lanes'
// counts meet in one __reduce_add_sync and lane 0 stores.  Lpad must be a
// multiple of 4 (the wrapper pads); nothing depends on Lpad past that.
//
// What bounds it on this card.  Operations: one 4-byte word compare per 4
// positions of each (row, lag) window, at 132 SMs x 128 lanes x clock; the
// smoke's 128 rows of 2-40 kb at the CLI's grid (380 lags 1,000-19,950
// every 50) hold 0.14 G word compares, 4.3 us at 1,980 MHz.  Bytes: the
// rows once, 2.7 MB, 0.9 us at 3.35 TB/s.  A word compare is ~10
// instructions here (three shared loads, the funnel shift, the compare,
// the tail test, the popcount and the loop) with little to overlap inside
// a warp, and a block of a 40 kb row keeps ~940 of them on each lane, so
// the launch is held by the instruction rate, far above the bound: 0.195
// ms on that batch (PERF.md, row 30).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;               // warps a block, a lag each
constexpr int kLagsPerBlock = 32;       // lags of a block's chunk

template <bool kShared>
__global__ void __launch_bounds__(kWarps * 32)
    autocorr_kernel(const uint8_t* __restrict__ rows,
                    const int* __restrict__ lens,
                    const int* __restrict__ lags, int* __restrict__ out,
                    int Lpad, int G, int chunks) {
    extern __shared__ uint32_t srow[];
    const int b = blockIdx.x / chunks;
    const int chunk = blockIdx.x % chunks;
    const int n = min(max(lens[b], 0), Lpad);
    const int nw = (n + 3) >> 2;        // words holding the row's bytes
    const uint32_t* grow =
        reinterpret_cast<const uint32_t*>(rows + (size_t)b * Lpad);
    const uint32_t* w = grow;
    if (kShared) {
        for (int k = threadIdx.x; k < nw; k += blockDim.x) srow[k] = grow[k];
        __syncthreads();
        w = srow;
    }
    const int lane = threadIdx.x & 31;
    const int g_end = min(G, (chunk + 1) * kLagsPerBlock);
    for (int g = chunk * kLagsPerBlock + (threadIdx.x >> 5); g < g_end;
         g += kWarps) {
        const int lag = lags[g];
        // the lag's window: positions p < m = n - lag
        const int m = lag >= 0 && lag < n ? n - lag : 0;
        const int q = lag >> 2;
        const unsigned sh = (unsigned)(lag & 3) << 3;
        const int mw = (m + 3) >> 2;
        unsigned acc = 0;
#pragma unroll 4
        for (int k = lane; k < mw; k += 32) {
            // word k + q + 1 may lie past the row: its bytes are all
            // masked below, so 0 stands in
            const uint32_t lo = w[k + q];
            const uint32_t hi = k + q + 1 < nw ? w[k + q + 1] : 0u;
            uint32_t eq = __vcmpeq4(w[k], __funnelshift_r(lo, hi, sh));
            const int rem = m - (k << 2);
            if (rem < 4) eq &= (1u << (rem << 3)) - 1u;
            acc += __popc(eq);
        }
        acc = __reduce_add_sync(0xffffffffu, acc);
        if (lane == 0) out[(size_t)b * G + g] = (int)(acc >> 3);
    }
}

size_t smem_bytes(int Lpad) { return (size_t)(Lpad / 4) * 4; }

// 1 when a row of Lpad bytes is staged into shared memory
int shared_route(int Lpad) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    return smem_bytes(Lpad) <= (size_t)optin;
}

}  // namespace

// The launch geometry for a (B, Lpad) batch and G lags: geo = {route (1
// shared, 0 device memory), blocks, threads a block, shared bytes}.
extern "C" int autocorr_geometry(int B, int Lpad, int G, int* geo) {
    const int chunks = (G + kLagsPerBlock - 1) / kLagsPerBlock;
    const int shared = shared_route(Lpad);
    geo[0] = shared;
    geo[1] = B * chunks;
    geo[2] = kWarps * 32;
    geo[3] = shared ? (int)smem_bytes(Lpad) : 0;
    return cudaSuccess;
}

// out (B, G) int32 <- the match counts of rows (B, Lpad) uint8 with lens
// (B,) int32 at lags (G,) int32, on `stream`.  Lpad % 4 == 0 and rows
// 4-byte aligned.
extern "C" int autocorr_launch(const uint8_t* rows, const int* lens,
                               const int* lags, int* out, int B, int Lpad,
                               int G, cudaStream_t stream) {
    if (B < 0 || G < 0 || Lpad < 0 || Lpad % 4 != 0 ||
        reinterpret_cast<uintptr_t>(rows) % 4 != 0)
        return cudaErrorInvalidValue;
    if (B == 0 || G == 0) return cudaSuccess;
    const int chunks = (G + kLagsPerBlock - 1) / kLagsPerBlock;
    if ((long long)B * chunks > INT_MAX) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(B * chunks);
    if (shared_route(Lpad)) {
        const size_t smem = smem_bytes(Lpad);
        if (smem > 48 * 1024) {
            const cudaError_t err = (cudaError_t)cudaFuncSetAttribute(
                autocorr_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        autocorr_kernel<true><<<grid, kWarps * 32, smem, stream>>>(
            rows, lens, lags, out, Lpad, G, chunks);
    } else {
        autocorr_kernel<false><<<grid, kWarps * 32, 0, stream>>>(
            rows, lens, lags, out, Lpad, G, chunks);
    }
    return cudaGetLastError();
}
