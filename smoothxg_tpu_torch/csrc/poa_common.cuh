// poa_common.cuh — device code shared by the whole-block POA kernels
// (poa_win.cu, poa_code.cu, poa_stacked.cu): the block shape, the score
// floor and the two block-wide reductions a DP row needs.  Everything sits in an anonymous namespace,
// so every translation unit keeps its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

// threads per block (POA_NT: a smaller block for emulation tests of the
// tile loops, whose tile then covers NT * CPT columns)
#ifndef POA_NT
#define POA_NT 256
#endif
constexpr int NT = POA_NT;
constexpr int CPT = 8;                // columns per thread per tile
constexpr int TILE = NT * CPT;        // columns per tile
constexpr int NWARP = NT / 32;
constexpr int32_t NEG = -(1 << 30);   // score floor (csrc/host/cpoa.cpp)
constexpr unsigned FULL = 0xffffffffu;

// max value, ties to the smaller index; the result lands in every thread
__device__ void reduce_best(int& v, int& r, int* sv, int* sr) {
    for (int o = 16; o; o >>= 1) {
        int ov = __shfl_down_sync(FULL, v, o);
        int orr = __shfl_down_sync(FULL, r, o);
        if (ov > v || (ov == v && orr < r)) { v = ov; r = orr; }
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) { sv[warp] = v; sr[warp] = r; }
    __syncthreads();
    v = sv[0]; r = sr[0];
    for (int w = 1; w < NWARP; ++w)
        if (sv[w] > v || (sv[w] == v && sr[w] < r)) { v = sv[w]; r = sr[w]; }
    __syncthreads();
}

// Block-wide exclusive prefix max, in thread order, of two per-thread
// values (t1, t2): ex* receive the max over the lower threads (INT_MIN for
// thread 0), tot* the max over the whole block.  A warp-shuffle inclusive
// scan, then a scan of the per-warp totals through shared memory (sw1,
// sw2: NWARP ints each).  One barrier: the caller alternates between two
// pairs of buffers, so a call never overwrites totals another warp of the
// previous call may still read.
__device__ __forceinline__ void block_excl_max2(int t1, int t2, int& ex1,
                                                int& ex2, int& tot1,
                                                int& tot2, int* sw1,
                                                int* sw2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int i1 = t1, i2 = t2;
    for (int o = 1; o < 32; o <<= 1) {
        int y1 = __shfl_up_sync(FULL, i1, o);
        int y2 = __shfl_up_sync(FULL, i2, o);
        if (lane >= o) { i1 = max(i1, y1); i2 = max(i2, y2); }
    }
    ex1 = __shfl_up_sync(FULL, i1, 1);
    ex2 = __shfl_up_sync(FULL, i2, 1);
    if (lane == 0) { ex1 = INT_MIN; ex2 = INT_MIN; }
    if (lane == 31) { sw1[warp] = i1; sw2[warp] = i2; }
    __syncthreads();
    tot1 = INT_MIN; tot2 = INT_MIN;
    for (int w = 0; w < NWARP; ++w) {
        if (w == warp) { ex1 = max(ex1, tot1); ex2 = max(ex2, tot2); }
        tot1 = max(tot1, sw1[w]);
        tot2 = max(tot2, sw2[w]);
    }
}

}  // namespace
