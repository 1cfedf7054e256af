// probes.cu — micro-probes of the costs that bound the port's POA kernels
// on Hopper (sm_90a): dependent loads from shared memory and from L2, loop
// overhead, element reads and writes of a plane, a warp's shuffle
// reduction, a block barrier per row, slab reads of a DP plane and a
// shift-max step over stacked rows.
//
// Replaces the Pallas TPU micro-probes of tools/ (each inner `mk*` builder
// reaching pl.pallas_call): probe_scalar_latency.py:mk, probe_smem.py:mk,
// probe_loop.py:mk_empty/mk_smem/mk_slab/mk_mwrite/mk_mread,
// probe_loop2.py:mk_*, probe_smem2.py:mk_cap/mk_rmw/mk_mwrite/mk_fillrow and
// probe_stack.py:mk_step.  Each kernel computes its TPU probe's (1, 128)
// int32 output exactly (the plain PyTorch versions are in
// smoothxg_tpu_torch/tools/_probe.py) and runs on one SM (grid 1), as a TPU
// probe times one TensorCore.  Four families, each a C entry point:
//   probe_scalar  one thread: an empty loop, table chases, independent
//                 reads, read-modify-writes, the 224 KiB table set; the
//                 table in shared memory (the counterpart of TPU SMEM) or
//                 in device memory read with __ldcg, so that each
//                 dependent load is an L2 round trip, as the graph tables
//                 of poa_graph.cuh are;
//   probe_row     the (32, 128) plane: element chases, reads and writes,
//                 by one thread or by one warp that loads the whole row
//                 and max-reduces it under the lane mask with shuffles (the
//                 TPU's masked row read, jnp.max(jnp.where(...)));
//   probe_tile    256 threads, one column each, 8 accumulator rows in
//                 registers: slab reads of a (4096, 256) plane in device
//                 memory, a fill-row body, and a fill row with a shared
//                 table, an hh plane in device memory and a barrier;
//   probe_step    the shift-max step on (8K, 256) rows: `block` = 256
//                 threads, one column each, the left neighbour by shuffle
//                 and through shared memory at a warp's edge, one
//                 __syncthreads a step (the per-row barrier of poa_win.cu /
//                 poa_code.cu); `warp` = a warp per 8 rows, 8 columns a
//                 lane, shuffles only (poa_stacked.cu's layout).
//
// What bounds them is what they measure: latency (dependent loads,
// shuffles, barriers), not bytes.  Arithmetic wraps as JAX's int32 does
// (uint32_t); scratch the TPU body reads before writing starts at zero, as
// interpret-mode Pallas gives it.  No loop has a closed form the compiler
// could fold: the counts are run-time arguments and the data comes from
// tables the kernel builds or from device inputs; and every row a case
// computes is stored at the end, so that none is dropped for feeding no
// output (the TPU computes whole (8, 128) tiles either way).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
//        -fPIC, one process per source, then one link into a shared
//        library (smoothxg_tpu_torch/ops/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr unsigned FULLMASK = 0xffffffffu;
constexpr int PLANE = 4096;            // the (32, 128) plane's elements
constexpr int CAP_VW = 4096;           // cap_224KB's node tables
constexpr int CAP_WORDS = 5 * CAP_VW + 8 * CAP_VW + 2 * 2048;   // 224 KiB
constexpr int32_t LANE_FLOOR = -(1 << 30);    // the masked read's fill

// ---- probe_scalar: one thread ----
enum Scalar { EMPTY, EMPTY_U8, CHASE, CHASE_U8, INDEP, RMW, RMW7, CAP,
              N_SCALAR };

template <bool SH>
__device__ __forceinline__ uint32_t ld(const uint32_t* t, uint32_t i) {
    if (SH) return t[i];
    return (uint32_t)__ldcg((const int*)t + i);
}

template <bool SH>
__device__ __forceinline__ void st(uint32_t* t, uint32_t i, uint32_t v) {
    if (SH) t[i] = v;
    else __stcg((int*)t + i, (int)v);
}

template <int C, bool SH>
__global__ void __launch_bounds__(1)
probe_scalar_kernel(int n, int sz, int32_t* table, int32_t* out) {
    extern __shared__ uint32_t s_tab[];
    uint32_t* t = SH ? s_tab : (uint32_t*)table;
    const uint32_t msk = (uint32_t)sz - 1;
    uint32_t acc = 0;
    if (C == EMPTY || C == EMPTY_U8) {
        acc = 1;
        if (C == EMPTY_U8) {
#pragma unroll 8
            for (int i = 0; i < n; ++i) acc = (acc * 5u + 1u) & 0xFFFFu;
        } else {
#pragma unroll 1
            for (int i = 0; i < n; ++i) acc = (acc * 5u + 1u) & 0xFFFFu;
        }
    } else if (C == CAP) {
        // bpp ring nxt npred nsucc (VW each), preds (8 VW), tgt, path
        uint32_t *bpp = t, *ring = t + CAP_VW, *nxt = t + 2 * CAP_VW,
                 *npred = t + 3 * CAP_VW, *nsucc = t + 4 * CAP_VW,
                 *preds = t + 5 * CAP_VW;
        for (int i = 0; i < CAP_WORDS; ++i) st<SH>(t, i, 0u);
        for (uint32_t i = 0; i < CAP_VW; ++i) {
            st<SH>(bpp, i, i); st<SH>(ring, i, i); st<SH>(nxt, i, i + 1);
            st<SH>(npred, i, 1u); st<SH>(nsucc, i, 1u); st<SH>(preds, i, i);
        }
        acc = 1;
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
            const uint32_t j = acc & (CAP_VW - 1);
            const uint32_t w = ld<SH>(bpp, j) + ld<SH>(ring, j)
                + ld<SH>(nxt, j) + ld<SH>(npred, j) + ld<SH>(preds, j);
            st<SH>(nsucc, j, w & 0xFFu);
            acc = (acc * 5u + w) & 0xFFFFu;
        }
        acc += ld<SH>(nsucc, 0);
    } else {
        for (uint32_t i = 0; i < (uint32_t)sz; ++i)
            st<SH>(t, i, C == RMW7 ? i % 7u : (i * 97u + 13u) & msk);
        if (C == CHASE_U8) {
#pragma unroll 8
            for (int i = 0; i < n; ++i) acc = ld<SH>(t, acc);
        } else if (C == CHASE) {
#pragma unroll 1
            for (int i = 0; i < n; ++i) acc = ld<SH>(t, acc);
        } else if (C == INDEP) {
#pragma unroll 1
            for (int i = 0; i < n; ++i) acc += ld<SH>(t, (uint32_t)i & msk);
        } else {                                   // RMW, RMW7
#pragma unroll 1
            for (int i = 0; i < n; ++i) {
                const uint32_t j = (uint32_t)i & msk;
                const uint32_t v = ld<SH>(t, j);
                st<SH>(t, j, v + 1u);
                acc += v;
            }
        }
    }
    for (int l = 0; l < 128; ++l) out[l] = (int32_t)acc;
}

// ---- probe_row: the (32, 128) plane, one thread or one warp ----
enum Row { R_CHASE, R_INDEP, R_INDEP4, R_MREAD, R_MREAD_U8, R_MWRITE,
           N_ROW };

// element `v` of the plane: one load (LANES 1), or the warp loads row
// v / 128 (4 elements a lane) and max-reduces it under the mask
// column == v % 128 (LANES 32)
template <bool SH, int LANES>
__device__ __forceinline__ uint32_t pread(const uint32_t* p, uint32_t v) {
    if (LANES == 1) return ld<SH>(p, v);
    const uint32_t lane = threadIdx.x & 31, row = v >> 7, col = v & 127;
    int m = LANE_FLOOR;
#pragma unroll
    for (uint32_t q = 0; q < 4; ++q) {
        const uint32_t c = lane + 32 * q;
        const int x = (int)ld<SH>(p, row * 128 + c);
        m = max(m, c == col ? x : LANE_FLOOR);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(FULLMASK, m, o));
    return (uint32_t)m;
}

// write `a` at element `v`: one store (LANES 1), or the warp reads the
// row, blends `a` in at column v % 128 and writes the row back
template <bool SH, int LANES>
__device__ __forceinline__ void pwrite(uint32_t* p, uint32_t v, uint32_t a) {
    if (LANES == 1) { st<SH>(p, v, a); return; }
    const uint32_t lane = threadIdx.x & 31, row = v >> 7, col = v & 127;
#pragma unroll
    for (uint32_t q = 0; q < 4; ++q) {
        const uint32_t c = lane + 32 * q;
        const uint32_t x = ld<SH>(p, row * 128 + c);
        st<SH>(p, row * 128 + c, c == col ? a : x);
    }
}

template <int C, bool SH, int LANES>
__global__ void __launch_bounds__(32)
probe_row_kernel(int n, const int32_t* plane, int32_t* scratch,
                 int32_t* out) {
    extern __shared__ uint32_t s_pln[];
    const int lane = threadIdx.x;
    uint32_t* p = SH ? s_pln
                : (C == R_MWRITE ? (uint32_t*)scratch : (uint32_t*)plane);
    if (SH || C == R_MWRITE) {
        for (int x = lane; x < PLANE; x += LANES)
            st<SH>(p, x, C == R_MWRITE ? 0u : (uint32_t)plane[x]);
        // each lane reads back only the columns it wrote: no barrier
    }
    uint32_t acc = 0;
    if (C == R_CHASE) {
#pragma unroll 1
        for (int i = 0; i < n; ++i) acc = pread<SH, LANES>(p, acc);
    } else if (C == R_INDEP) {
#pragma unroll 1
        for (int i = 0; i < n; ++i)
            acc += pread<SH, LANES>(p, (uint32_t)i & (PLANE - 1));
    } else if (C == R_INDEP4) {
#pragma unroll 1
        for (int i = 0; i < n / 4; ++i) {
            const uint32_t j = 4u * (uint32_t)i;
            acc += pread<SH, LANES>(p, j & (PLANE - 1))
                 + pread<SH, LANES>(p, (j + 1) & (PLANE - 1))
                 + pread<SH, LANES>(p, (j + 2) & (PLANE - 1))
                 + pread<SH, LANES>(p, (j + 3) & (PLANE - 1));
        }
    } else if (C == R_MREAD_U8) {
#pragma unroll 8
        for (int i = 0; i < n; ++i)
            acc += pread<SH, LANES>(p, ((uint32_t)i * 13u) & (PLANE - 1));
    } else if (C == R_MREAD) {
#pragma unroll 1
        for (int i = 0; i < n; ++i)
            acc += pread<SH, LANES>(p, ((uint32_t)i * 13u) & (PLANE - 1));
    } else {                                       // R_MWRITE
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
            pwrite<SH, LANES>(p, ((uint32_t)i * 13u) & (PLANE - 1), acc);
            acc += 1u;
        }
    }
    for (int l = lane; l < 128; l += LANES)
        out[l] = (int32_t)(C == R_MWRITE ? ld<SH>(p, l) + acc : acc);
}

// ---- probe_tile: 256 threads, one column each ----
enum Tile { T_SLAB, T_SLAB_U8, T_VECROW, T_FILLROW, N_TILE };
constexpr int TCOLS = 256, TROWS = 8;

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);
}

template <int C>
__global__ void __launch_bounds__(TCOLS)
probe_tile_kernel(int n, const int32_t* __restrict__ x, int32_t* hh,
                  int32_t* out) {
    extern __shared__ uint32_t s_sm[];
    const int col = threadIdx.x;
    int acc[TROWS];
#pragma unroll
    for (int r = 0; r < TROWS; ++r) acc[r] = 0;
    if (C == T_SLAB || C == T_SLAB_U8) {
        if (C == T_SLAB_U8) {
#pragma unroll 8
            for (int i = 0; i < n; ++i) {
                const int32_t* s = x + (size_t)8 * (i & 511) * TCOLS + col;
#pragma unroll
                for (int r = 0; r < TROWS; ++r)
                    acc[r] = wadd(acc[r], s[r * TCOLS]);
            }
        } else {
#pragma unroll 1
            for (int i = 0; i < n; ++i) {
                const int32_t* s = x + (size_t)8 * (i & 511) * TCOLS + col;
#pragma unroll
                for (int r = 0; r < TROWS; ++r)
                    acc[r] = wadd(acc[r], s[r * TCOLS]);
            }
        }
    } else if (C == T_VECROW) {
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
            const int32_t* s = x + (size_t)8 * (i & 511) * TCOLS + col;
#pragma unroll
            for (int r = 0; r < TROWS; ++r) {
                int v = s[r * TCOLS];
#pragma unroll
                for (int u = 0; u < 5; ++u) {
                    v = wadd(max(v, acc[r]), 1);
                    acc[r] = v > acc[r] ? wadd(v, -3) : acc[r];
                }
            }
        }
    } else {                                       // T_FILLROW
        for (int i = col; i < PLANE; i += TCOLS)
            s_sm[i] = ((uint32_t)i * 97u + 13u) & (PLANE - 1);
        for (int r = 0; r < 2048; ++r) hh[(size_t)r * TCOLS + col] = 0;
        __syncthreads();
        uint32_t v = 0;
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
            // the table index stays below 4096 for every N the probes
            // run (the TPU body does not mask it); the mask keeps a
            // larger N inside the table
            v &= PLANE - 1;
            const uint32_t a = s_sm[v], b = s_sm[(v + 1) & (PLANE - 1)],
                           cc = s_sm[(v + 2) & (PLANE - 1)];
            if (col == 0) s_sm[(v + 3) & (PLANE - 1)] = a + 1u;
            const int32_t* s = x + (size_t)8 * (a & 511) * TCOLS + col;
            int32_t* yb = hh + (size_t)8 * (b & 255) * TCOLS + col;
            int32_t* wb = hh + (size_t)8 * (cc & 255) * TCOLS + col;
#pragma unroll
            for (int r = 0; r < TROWS; ++r) {
                int xv = s[r * TCOLS];
                const int y = yb[r * TCOLS];
#pragma unroll
                for (int u = 0; u < 6; ++u) {
                    xv = wadd(max(xv, acc[r]), 1);
                    acc[r] = xv > acc[r] ? wadd(xv, -3) : wadd(acc[r], y);
                }
            }
#pragma unroll
            for (int r = 0; r < TROWS; ++r) wb[r * TCOLS] = acc[r];
            v = s_sm[v];
            __syncthreads();            // orders thread 0's table write
        }
    }
    // the function's output is row 0; storing every row keeps the
    // compiler from dropping rows 1-7, which feed nothing else
    if (C != T_FILLROW) {
#pragma unroll
        for (int r = 0; r < TROWS; ++r) hh[(size_t)r * TCOLS + col] = acc[r];
    }
    if (col < 128) out[col] = acc[0];
}

// ---- probe_step: x = max(x, where(lane >= 1 + (i & 7), roll(x, 1),
// -16000)) on (8K, 256) rows ----
constexpr int STEP_FLOOR = -16000;

template <int K>
__global__ void __launch_bounds__(TCOLS)
probe_step_block_kernel(int n, const int32_t* __restrict__ plane,
                        int32_t* out) {
    __shared__ int s_edge[2][TCOLS / 32][8 * K];
    const int col = threadIdx.x, lane = col & 31, warp = col >> 5;
    const int lwarp = (warp + TCOLS / 32 - 1) % (TCOLS / 32);
    int x[8 * K];
#pragma unroll
    for (int r = 0; r < 8 * K; ++r) x[r] = plane[r * TCOLS + col];
    int buf = 0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
        const int k = 1 + (i & 7);
        if (lane == 31)
#pragma unroll
            for (int r = 0; r < 8 * K; ++r) s_edge[buf][warp][r] = x[r];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 8 * K; ++r) {
            int left = __shfl_up_sync(FULLMASK, x[r], 1);
            if (lane == 0) left = s_edge[buf][lwarp][r];
            x[r] = max(x[r], col >= k ? left : STEP_FLOOR);
        }
        buf ^= 1;
    }
    if (col < 128) out[col] = wadd(n, x[0]);
}

template <int K>
__global__ void __launch_bounds__(32 * K)
probe_step_warp_kernel(int n, const int32_t* __restrict__ plane,
                       int32_t* sink, int32_t* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = 8 * lane;
    int x[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q)
            x[r][q] = plane[(8 * warp + r) * TCOLS + c0 + q];
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
        const int k = 1 + (i & 7);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int in = __shfl_sync(FULLMASK, x[r][7], (lane + 31) & 31);
#pragma unroll
            for (int q = 7; q >= 1; --q)
                x[r][q] = max(x[r][q], c0 + q >= k ? x[r][q - 1] : STEP_FLOOR);
            x[r][0] = max(x[r][0], c0 >= k ? in : STEP_FLOOR);
        }
    }
    // every row back to device memory: rows other than warp 0's row 0
    // feed no output, and the compiler would drop them
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q)
            sink[(8 * warp + r) * TCOLS + c0 + q] = x[r][q];
    if (warp == 0 && lane < 16)
#pragma unroll
        for (int q = 0; q < 8; ++q) out[c0 + q] = wadd(n, x[0][q]);
}

// ---- launch tables ----
int opt_in(const void* fn, size_t smem) { return (int)opt_in_smem(fn, smem); }

template <int C, bool SH>
int launch_scalar(int n, int sz, int32_t* table, int32_t* out, size_t smem,
                  cudaStream_t stream) {
    const int err = opt_in((const void*)probe_scalar_kernel<C, SH>, smem);
    if (err) return err;
    probe_scalar_kernel<C, SH><<<1, 1, smem, stream>>>(n, sz, table, out);
    return (int)cudaGetLastError();
}

template <int C, bool SH, int LANES>
int launch_row(int n, const int32_t* plane, int32_t* scratch, int32_t* out,
               cudaStream_t stream) {
    probe_row_kernel<C, SH, LANES><<<1, LANES, SH ? PLANE * 4 : 0, stream>>>(
        n, plane, scratch, out);
    return (int)cudaGetLastError();
}

template <int C>
int launch_tile(int n, const int32_t* x, int32_t* hh, int32_t* out,
                cudaStream_t stream) {
    probe_tile_kernel<C><<<1, TCOLS, C == T_FILLROW ? PLANE * 4 : 0,
                           stream>>>(n, x, hh, out);
    return (int)cudaGetLastError();
}

template <int K>
int launch_step(int layout, int n, const int32_t* plane, int32_t* sink,
                int32_t* out, cudaStream_t stream) {
    if (layout == 0)
        probe_step_block_kernel<K><<<1, TCOLS, 0, stream>>>(n, plane, out);
    else
        probe_step_warp_kernel<K><<<1, 32 * K, 0, stream>>>(n, plane, sink,
                                                            out);
    return (int)cudaGetLastError();
}

using ScalarFn = int (*)(int, int, int32_t*, int32_t*, size_t, cudaStream_t);
constexpr ScalarFn SCALAR[N_SCALAR][2] = {
    {launch_scalar<EMPTY, true>, launch_scalar<EMPTY, false>},
    {launch_scalar<EMPTY_U8, true>, launch_scalar<EMPTY_U8, false>},
    {launch_scalar<CHASE, true>, launch_scalar<CHASE, false>},
    {launch_scalar<CHASE_U8, true>, launch_scalar<CHASE_U8, false>},
    {launch_scalar<INDEP, true>, launch_scalar<INDEP, false>},
    {launch_scalar<RMW, true>, launch_scalar<RMW, false>},
    {launch_scalar<RMW7, true>, launch_scalar<RMW7, false>},
    {launch_scalar<CAP, true>, launch_scalar<CAP, false>}};

using RowFn = int (*)(int, const int32_t*, int32_t*, int32_t*, cudaStream_t);
#define ROW_FNS(C)                                                         \
    {{launch_row<C, true, 1>, launch_row<C, true, 32>},                    \
     {launch_row<C, false, 1>, launch_row<C, false, 32>}}
constexpr RowFn ROW[N_ROW][2][2] = {
    ROW_FNS(R_CHASE), ROW_FNS(R_INDEP), ROW_FNS(R_INDEP4),
    ROW_FNS(R_MREAD), ROW_FNS(R_MREAD_U8), ROW_FNS(R_MWRITE)};
#undef ROW_FNS

using TileFn = int (*)(int, const int32_t*, int32_t*, int32_t*,
                       cudaStream_t);
constexpr TileFn TILE_FNS[N_TILE] = {launch_tile<T_SLAB>,
                                     launch_tile<T_SLAB_U8>,
                                     launch_tile<T_VECROW>,
                                     launch_tile<T_FILLROW>};

}  // namespace

extern "C" {

// Each entry launches one probe on `stream` (PyTorch's current stream)
// with grid 1 and returns cudaGetLastError() after the launch (nonzero:
// refused, or an earlier fault pending; the caller raises).  `out` is 128
// int32.  Case numbers are the enums above, mirrored by
// smoothxg_tpu_torch/tools/_probe.py.

// mem 0 = shared, 1 = device memory (`table`, >= sz words, or 57,344 for
// the cap case); sz a power of two (the table's words)
int probe_scalar_launch(int kase, int mem, int n, int sz, void* table,
                        void* out, void* stream) {
    if (kase < 0 || kase >= N_SCALAR || mem < 0 || mem > 1 || n < 0 ||
        sz < 1 || (sz & (sz - 1)))
        return (int)cudaErrorInvalidValue;
    const size_t words = kase == CAP ? CAP_WORDS : (size_t)sz;
    const size_t smem = mem == 0 && kase != EMPTY && kase != EMPTY_U8
        ? words * 4 : 0;
    return SCALAR[kase][mem](n, sz, (int32_t*)table, (int32_t*)out, smem,
                             (cudaStream_t)stream);
}

// mem as above; lanes 1 or 32; plane = the (32, 128) input, scratch = the
// (32, 128) plane the write case writes in device memory
int probe_row_launch(int kase, int mem, int lanes, int n, const void* plane,
                     void* scratch, void* out, void* stream) {
    if (kase < 0 || kase >= N_ROW || mem < 0 || mem > 1 || n < 0 ||
        (lanes != 1 && lanes != 32))
        return (int)cudaErrorInvalidValue;
    return ROW[kase][mem][lanes == 32](n, (const int32_t*)plane,
                                       (int32_t*)scratch, (int32_t*)out,
                                       (cudaStream_t)stream);
}

// x = the (4096, 256) input, hh = the (2048, 256) scratch of the fill row
// (the other cases store their 8 accumulator rows in its first rows)
int probe_tile_launch(int kase, int n, const void* x, void* hh, void* out,
                      void* stream) {
    if (kase < 0 || kase >= N_TILE || n < 0)
        return (int)cudaErrorInvalidValue;
    return TILE_FNS[kase](n, (const int32_t*)x, (int32_t*)hh, (int32_t*)out,
                          (cudaStream_t)stream);
}

// layout 0 = block, 1 = warp; k in {1, 2, 4, 8}; plane = the (8k, 256)
// initial rows, sink = (8k, 256) scratch the warp layout stores its rows in
int probe_step_launch(int layout, int k, int n, const void* plane,
                      void* sink, void* out, void* stream) {
    if (layout < 0 || layout > 1 || n < 0) return (int)cudaErrorInvalidValue;
    const int32_t* p = (const int32_t*)plane;
    int32_t *w = (int32_t*)sink, *o = (int32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return launch_step<1>(layout, n, p, w, o, s);
        case 2: return launch_step<2>(layout, n, p, w, o, s);
        case 4: return launch_step<4>(layout, n, p, w, o, s);
        case 8: return launch_step<8>(layout, n, p, w, o, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
