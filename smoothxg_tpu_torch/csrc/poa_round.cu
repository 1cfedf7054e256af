// poa_round.cu — one round of partial order alignment on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smoothxg_tpu/ops/poa_pallas.py:_pallas_fn
// (kernel body :71, pallas_call :404), the device half of `--engine
// pallas`.  Each task of a launch aligns one sequence against one POA
// graph whose nodes arrive in topological rows: the sequence-vs-DAG DP fill,
// the end cell, and a traceback that emits packed move codes.  The
// semantics are those of the scalar oracle smoothxg_tpu/ops/poa_host.py:
// fill/align (and of the port's copy, ops/poa_host.py), bit for bit, and
// of the plain PyTorch version smoothxg_tpu_torch/ops/poa_round.py:
// poa_round_reference, which is written line for line against this file:
//   * fill (poa_host.py:84-161): M from the max over predecessor rows of H
//     at column j-1, E1/E2 open from H or extend E, Hq = max(M, E1, E2)
//     (and 0 when local), F1/F2 as a prefix max of Hq + ext*j, H = max;
//     int32 scores with the floor NEG = -2^30 (no int16 clamp);
//   * local end cell: the first row holding the strict maximum, then the
//     first column in it; global: the sink with the highest H[., L],
//     lowest row on ties;
//   * traceback (poa_host.py:194-265): M over the predecessors in slot
//     order, then E1, then E2; F takes the nearest origin k, channel 1
//     before channel 2; an E step tries opening over the predecessors
//     before extending; local stops at value 0, global takes leading
//     insertions through row 0.
// Output contract of the Pallas kernel, with the move codes widened to 64
// bits: codes ((i+2) << 32) | (j+2) in traceback order (end to start;
// i = -1 an insertion, j = -1 a deletion), so no graph or sequence size
// overflows a code (the Pallas kernel packs (i+2) << 15 into int32, which
// bounds L + 2 below 2^15 and V + 2 below 2^16; ops/poa_round.py:
// to_pallas_layout converts), and meta = (n_moves, best score, flag, 0),
// flag 1 a stuck traceback, 2 the iteration limit overrun.  A task with
// V == 0 or L == 0 is done at once: meta = (0, NEG, 0, 0).
//
// The wrapper zeroes `codes` first, so codes past n_moves are 0.
//
// What bounds it on this card.  Operations: the recurrence needs 23 int32
// operations per DP cell when local and 21 when global (substitution 3;
// E1 and E2 4 each; Hq 2, + 1 for the local floor at 0; F1 and F2 3 each
// as F(j) = max(F(j-1) - ext, Hq(j-1) - open); H 2; the local row maximum
// 1), plus 3 per predecessor past the first (the maxima of H, E1 and E2);
// that count over the launch's cells at 132 SMs x 128 int32 lanes per
// clock is the bound (chip_smoke.py counts it from each launch's tasks).
// But every cell depends on the rows above, so a task's V rows run one
// after another and only the L + 1 columns of a row are parallel: what
// the card spends is the latency of one row times V, then of one
// traceback step times V + L.  A round holds ~90 tasks, fewer than the
// SMs, so what matters is the latency of one task.
//
// The design (one thread block per task; `round_geometry` below):
//   * the block is sized to the launch's row: each thread owns 4 columns
//     (one int4, lane-major, so a warp's access to a plane row is 512
//     contiguous bytes), and the block has ceil((LS + 1) / 4) threads
//     rounded up to a warp, at most MAX_NT; a launch whose rows are longer
//     than 4 MAX_NT columns walks them in tiles;
//   * where a row is one tile (the main path's rows of ~1 kb), the last
//     RING_ROWS rows of H, E1 and E2 stay in a ring in shared memory, so a
//     predecessor within 7 rows (99.7% of predecessor reads on the smoke's
//     round tasks, tools/ring_reach.py) is read from shared memory; device
//     memory holds every row for the traceback and for older predecessors.
//     The row needs one barrier, the F scan's: the only value a thread reads
//     from the row just written and does not own is H at the column left
//     of its first, which it takes from its left lane by a shuffle or, at
//     a warp's first lane, rebuilds from the partial maxima the left warp
//     publishes for the scan (`hleft`);
//   * the task's row tables (predecessor rows, their count, base, sink)
//     are staged once into shared memory as int16 when they fit, else the
//     count goes to device scratch and the rest is read from the inputs
//     (a task past int16 nodes); the next row's metadata is issued before
//     this row's scan;
//   * the traceback runs in warp 0: every lane follows the same path; a
//     run of up to 32 M moves along rows whose only predecessor is the row
//     above is read ahead, one step a lane, and taken up to its first
//     other step (a warp scan of the substitution scores gives each
//     step's value); any other step's plane reads (E1, E2 and each
//     predecessor's H, one predecessor a lane) are issued together and
//     the first match is a ballot, and the F origin is searched 32 columns
//     at a time with a ballot for the nearest.
// Predecessor slots past a node's in-degree repeat its first predecessor
// (the packing contract); a row's count stops at the first repeat.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
//        -fPIC, one process per source, then one link into one library
//        with the other kernels (smoothxg_tpu_torch/ops/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "smem.cuh"

namespace {

constexpr int32_t NEG = -(1 << 30);   // score floor (csrc/host/cpoa.cpp)
constexpr unsigned FULL = 0xffffffffu;
constexpr int SHIFT = 32;
constexpr int MAX_NT = 512;           // threads per block at most
constexpr int MAX_WARPS = MAX_NT / 32;
constexpr int TILE_MAX = 4 * MAX_NT;  // columns of one tile at most
constexpr int RING_ROWS = 8;          // rows of H, E1, E2 in shared memory
constexpr int ID16_MAX = 32767;       // node rows that fit an int16
constexpr int STATIC_SMEM = 1024;     // above the kernel's static buffers
// longest sequence kept in shared memory on the tiled route; a longer one
// is read from device memory instead
constexpr int SMEM_SEQ_MAX = 32768;

__host__ __device__ inline int row_cols(int LS) {    // stored columns a row
    return (LS + 1 + 3) & ~3;
}

__host__ __device__ inline size_t align16(size_t x) {
    return (x + 15) & ~(size_t)15;
}

// int32 words of one task's device scratch: the planes H, Hq, E1, E2, each
// (VW + 1) x row_cols(LS), then the predecessor count of every row (used
// when the row tables stay in device memory) — mirrored by
// ops/poa_round.py:scratch_words
__host__ __device__ inline size_t task_words(int VW, int LS) {
    return 4 * ((size_t)VW + 1) * row_cols(LS) + (((size_t)VW + 3) & ~3);
}

// the row tables in shared memory: int16 predecessor rows (P a row), int16
// counts, uint8 bases and sinks
__host__ __device__ inline size_t table_bytes(int VW, int P) {
    return align16(2 * (size_t)VW * P + 4 * (size_t)VW);
}

__host__ __device__ inline size_t ring_bytes(int LS) {
    return 3 * (size_t)RING_ROWS * row_cols(LS) * 4;
}

__device__ __forceinline__ int64_t move_code(int i, int j) {
    return ((int64_t)(i + 2) << SHIFT) | (int64_t)(j + 2);
}

// The task's row tables.  Row r of the tables is DP row r + 1; its count
// of real predecessor rows is at least 1 (a node without predecessors
// reads row 0).  TSMEM: staged in shared memory (int16 rows); else the
// inputs' int32 rows and bases, and counts staged in device scratch.
template <bool TSMEM>
struct RowTab {
    const int16_t* pr16;
    const int16_t* np16;
    const uint8_t* base8;
    const uint8_t* sink8;
    const int32_t* pr32;
    const int32_t* np32;
    int P;
    __device__ __forceinline__ int np(int r) const {
        if constexpr (TSMEM) return np16[r]; else return np32[r];
    }
    __device__ __forceinline__ int pred(int r, int p) const {
        if constexpr (TSMEM) return pr16[(size_t)r * P + p];
        else return pr32[(size_t)r * P + p];
    }
    __device__ __forceinline__ int base(int r) const { return base8[r]; }
    __device__ __forceinline__ int sink(int r) const { return sink8[r]; }
};

// a DP row's metadata, loaded one row ahead: predecessor count, base, the
// first four predecessor rows (a row with more reads the rest in the loop)
struct RowMeta {
    int np, bv, pr[4];
};

template <bool TSMEM>
__device__ __forceinline__ RowMeta row_meta(const RowTab<TSMEM>& tab,
                                            int i) {
    RowMeta r;
    r.np = tab.np(i - 1);
    r.bv = tab.base(i - 1);
#pragma unroll
    for (int p = 0; p < 4; ++p)
        r.pr[p] = p < tab.P ? tab.pred(i - 1, p) : 0;
    return r;
}

__device__ __forceinline__ int part(const int4& v, int x) {
    return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

// max value, ties to the smaller index, over the block; the result lands
// in every thread
__device__ void reduce_best(int& v, int& r, int* sv, int* sr, int nw) {
    for (int o = 16; o; o >>= 1) {
        const int ov = __shfl_down_sync(FULL, v, o);
        const int orr = __shfl_down_sync(FULL, r, o);
        if (ov > v || (ov == v && orr < r)) { v = ov; r = orr; }
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) { sv[warp] = v; sr[warp] = r; }
    __syncthreads();
    v = sv[0]; r = sr[0];
    for (int w = 1; w < nw; ++w)
        if (sv[w] > v || (sv[w] == v && sr[w] < r)) { v = sv[w]; r = sr[w]; }
    __syncthreads();
}

// The kernel.  RING: every row is one tile and the last RING_ROWS rows sit
// in shared memory (one barrier a row); else rows are walked in tiles of
// 4 blockDim.x columns with predecessor rows from device memory (a
// barrier a tile and one a row).  TSMEM: the row tables in shared memory.
template <bool RING, bool TSMEM>
__global__ void __launch_bounds__(MAX_NT, 1)
poa_round_kernel(const int32_t* __restrict__ nv,
                 const int32_t* __restrict__ slen,
                 const int32_t* __restrict__ par,
                 const uint8_t* __restrict__ base,
                 const uint8_t* __restrict__ sink,
                 const int32_t* __restrict__ preds,
                 const uint8_t* __restrict__ seq, int64_t* codes,
                 int32_t* meta, int32_t* scratch, int VW, int LS, int P,
                 int local, int seq_smem) {
    // dynamic: the ring (RING), the sequence shifted by one (s_seq[j] =
    // char j - 1, so column j's M term reads s_seq[j]), the row tables
    // (TSMEM); each part 16-byte aligned
    extern __shared__ int4 s_dyn[];
    __shared__ int s_w1[2][MAX_WARPS], s_w2[2][MAX_WARPS];
    __shared__ int s_q1[2][MAX_WARPS], s_q2[2][MAX_WARPS],
        s_hq[2][MAX_WARPS];
    __shared__ int s_rv[MAX_WARPS], s_rr[MAX_WARPS];

    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int NTB = blockDim.x, nw = NTB >> 5;
    const int V = nv[b], L = slen[b];
    const int32_t* pp = par + (size_t)b * 6;
    const int m = pp[0], n = pp[1], g = pp[2], e = pp[3], q = pp[4],
              c = pp[5];
    const int C = row_cols(LS);
    const size_t plane = ((size_t)VW + 1) * C;
    int32_t* H = scratch + (size_t)b * task_words(VW, LS);
    int32_t* Hq = H + plane;
    int32_t* E1 = Hq + plane;
    int32_t* E2 = E1 + plane;
    int32_t* gnp = E2 + plane;
    const int CW = VW + LS + 1;
    int64_t* out = codes + (size_t)b * CW;

    int8_t* sm = (int8_t*)s_dyn;
    int32_t* ring = (int32_t*)sm;                 // [3][RING_ROWS][C]
    uint8_t* s_seq = (uint8_t*)(sm + (RING ? ring_bytes(LS) : 0));
    const uint8_t* gseq = seq + (size_t)b * LS;
    int8_t* s_tab = (int8_t*)s_seq + (seq_smem ? align16((size_t)C + 4) : 0);

    RowTab<TSMEM> tab;
    tab.P = P;
    if constexpr (TSMEM) {
        tab.pr16 = (const int16_t*)s_tab;
        tab.np16 = tab.pr16 + (size_t)VW * P;
        tab.base8 = (const uint8_t*)(tab.np16 + VW);
        tab.sink8 = tab.base8 + VW;
    } else {
        tab.pr32 = preds + (size_t)b * VW * P;
        tab.np32 = gnp;
        tab.base8 = base + (size_t)b * VW;
        tab.sink8 = sink + (size_t)b * VW;
    }

    if (V <= 0 || L <= 0) {                       // padded or empty task
        if (tid == 0) {
            meta[4 * b] = 0; meta[4 * b + 1] = NEG;
            meta[4 * b + 2] = 0; meta[4 * b + 3] = 0;
        }
        return;
    }

    // ---- stage the sequence and the row tables; row 0 (the virtual
    // source) into device memory and the ring ----
    if (seq_smem)
        for (int j = tid; j <= L; j += NTB)
            s_seq[j] = j == 0 ? 0 : gseq[j - 1];
    for (int r = tid; r < V; r += NTB) {
        const int32_t* rp = preds + ((size_t)b * VW + r) * P;
        const int p0 = rp[0];
        int k = 1;
        while (k < P && rp[k] != p0) ++k;
        if constexpr (TSMEM) {
            int16_t* pr = (int16_t*)tab.pr16 + (size_t)r * P;
            for (int p = 0; p < k; ++p) pr[p] = (int16_t)rp[p];
            ((int16_t*)tab.np16)[r] = (int16_t)k;
            ((uint8_t*)tab.base8)[r] = base[(size_t)b * VW + r];
            ((uint8_t*)tab.sink8)[r] = sink[(size_t)b * VW + r];
        } else {
            gnp[r] = k;
        }
    }
    for (int j = tid; j <= L; j += NTB) {
        int32_t h, hq;
        if (local || j == 0) { h = 0; hq = 0; }
        else {
            h = max(-(g + (j - 1) * e), -(q + (j - 1) * c));
            hq = NEG;
        }
        H[j] = h; Hq[j] = hq; E1[j] = NEG; E2[j] = NEG;
        if (RING) { ring[j] = h; ring[RING_ROWS * C + j] = NEG;
                    ring[2 * RING_ROWS * C + j] = NEG; }
    }
    __syncthreads();

    // the sequence character of column j >= 1
    auto sqc = [&](int j) -> int {
        return seq_smem ? (int)s_seq[j] : (int)gseq[j - 1];
    };

    // ---- DP fill, one row per topological position ----
    int tbest = INT_MIN, trow = 0;        // local end cell, per thread
    int buf = 0;
    const int TILE = 4 * NTB;
    const int ntiles = RING ? 1 : (L + TILE) / TILE;
    // H of the previous row at the column left of this thread's first
    // (RING: the row was written without a barrier since)
    int hleft = NEG;
    if (RING && tid > 0)
        hleft = local ? 0 : max(-(g + (4 * tid - 2) * e),
                                -(q + (4 * tid - 2) * c));
    RowMeta cur = row_meta(tab, 1), nxt = cur;
    for (int i = 1; i <= V; ++i) {
        if (i < V) nxt = row_meta(tab, i + 1);
        const int np = cur.np;
        int carry1 = NEG, carry2 = NEG;
        int rowbest = INT_MIN;
        int32_t* Hi = H + (size_t)i * C;
        int32_t* Hqi = Hq + (size_t)i * C;
        int32_t* E1i = E1 + (size_t)i * C;
        int32_t* E2i = E2 + (size_t)i * C;
        const int slot = i & (RING_ROWS - 1);
        int hleft_next = NEG;
        for (int tl = 0; tl < ntiles; ++tl) {
            const int j0 = tl * TILE + 4 * tid;
            const bool inrow = j0 < C;            // the int4 lies in the row
            // predecessor maxima: H at j0-1 .. j0+3, E1 and E2 at j0 ..
            // j0+3
            int hp0 = NEG, hp[4], x1[4], x2[4];
            auto take = [&](int p, int pr) {
                const int d = i - pr;
                int4 h = make_int4(NEG, NEG, NEG, NEG), y1 = h, y2 = h;
                int hl = NEG;
                if (RING && d < RING_ROWS) {
                    const int s = pr & (RING_ROWS - 1);
                    if (inrow) {
                        h = *(const int4*)(ring + (size_t)s * C + j0);
                        y1 = *(const int4*)(ring + (size_t)(RING_ROWS + s) * C
                                            + j0);
                        y2 = *(const int4*)(ring
                                            + (size_t)(2 * RING_ROWS + s) * C
                                            + j0);
                    }
                    if (lane == 0 && j0 > 0 && inrow)
                        hl = d == 1 ? hleft : ring[(size_t)s * C + j0 - 1];
                } else {
                    const size_t rb = (size_t)pr * C + j0;
                    if (inrow) {
                        h = *(const int4*)(H + rb);
                        y1 = *(const int4*)(E1 + rb);
                        y2 = *(const int4*)(E2 + rb);
                    }
                    if (lane == 0 && j0 > 0 && inrow) hl = H[rb - 1];
                }
                // the column left of this thread's first is the left lane's
                // last (a warp's first lane loaded it above)
                const int up = __shfl_up_sync(FULL, h.w, 1);
                if (lane > 0) hl = j0 > 0 ? up : NEG;
                if (p == 0) {
                    hp0 = hl;
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        hp[x] = part(h, x); x1[x] = part(y1, x);
                        x2[x] = part(y2, x);
                    }
                } else {
                    hp0 = max(hp0, hl);
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        hp[x] = max(hp[x], part(h, x));
                        x1[x] = max(x1[x], part(y1, x));
                        x2[x] = max(x2[x], part(y2, x));
                    }
                }
            };
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                if (p >= np) break;
                take(p, cur.pr[p]);
            }
            for (int p = 4; p < np; ++p) take(p, tab.pred(i - 1, p));

            int hq[4], t1 = INT_MIN, t2 = INT_MIN;
            int4 ve1, ve2;
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int j = j0 + x;
                int e1 = NEG, e2 = NEG, h = NEG;
                if (j <= L) {
                    const int hpl = x == 0 ? hp0 : hp[x - 1];
                    const int M = j == 0 ? NEG
                        : hpl + (sqc(j) == cur.bv ? m : -n);
                    e1 = max(max(hp[x] - g, x1[x] - e), NEG);
                    e2 = max(max(hp[x] - q, x2[x] - c), NEG);
                    h = max(M, max(e1, e2));
                    if (local) h = max(h, 0);
                    t1 = max(t1, h + e * j);
                    t2 = max(t2, h + c * j);
                }
                hq[x] = h;
                if (x == 0) { ve1.x = e1; ve2.x = e2; }
                else if (x == 1) { ve1.y = e1; ve2.y = e2; }
                else if (x == 2) { ve1.z = e1; ve2.z = e2; }
                else { ve1.w = e1; ve2.w = e2; }
            }
            if (inrow) {
                *(int4*)(Hqi + j0) = make_int4(hq[0], hq[1], hq[2], hq[3]);
                *(int4*)(E1i + j0) = ve1;
                *(int4*)(E2i + j0) = ve2;
                if (RING) {
                    *(int4*)(ring + (size_t)(RING_ROWS + slot) * C + j0) = ve1;
                    *(int4*)(ring + (size_t)(2 * RING_ROWS + slot) * C + j0)
                        = ve2;
                }
            }

            // the F scan: a warp-shuffle inclusive scan of the thread
            // maxima, the warp totals through shared memory (double
            // buffered, so one barrier serves)
            int i1 = t1, i2 = t2;
            for (int o = 1; o < 32; o <<= 1) {
                const int y1 = __shfl_up_sync(FULL, i1, o);
                const int y2 = __shfl_up_sync(FULL, i2, o);
                if (lane >= o) { i1 = max(i1, y1); i2 = max(i2, y2); }
            }
            int ex1 = __shfl_up_sync(FULL, i1, 1);
            int ex2 = __shfl_up_sync(FULL, i2, 1);
            if (lane == 0) { ex1 = INT_MIN; ex2 = INT_MIN; }
            if (lane == 31) {
                s_w1[buf][warp] = i1; s_w2[buf][warp] = i2;
                if (RING) {
                    // for the next warp's first lane: this lane's prefix up
                    // to its third column, and Hq at its last
                    int a1 = ex1, a2 = ex2;
#pragma unroll
                    for (int x = 0; x < 3; ++x)
                        if (j0 + x <= L) {
                            a1 = max(a1, hq[x] + e * (j0 + x));
                            a2 = max(a2, hq[x] + c * (j0 + x));
                        }
                    s_q1[buf][warp] = a1; s_q2[buf][warp] = a2;
                    s_hq[buf][warp] = hq[3];
                }
            }
            __syncthreads();
            // the warp totals' inclusive prefix max, lane w holding warps
            // 0..w (a shuffle scan, as deep as the block has warps); from it
            // the max over the warps before this one's left neighbour
            // (pre), before this one (into ex) and over all (tot)
            int w1 = lane < nw ? s_w1[buf][lane] : INT_MIN;
            int w2 = lane < nw ? s_w2[buf][lane] : INT_MIN;
            for (int o = 1; o < nw; o <<= 1) {
                const int y1 = __shfl_up_sync(FULL, w1, o);
                const int y2 = __shfl_up_sync(FULL, w2, o);
                if (lane >= o) { w1 = max(w1, y1); w2 = max(w2, y2); }
            }
            const int bw1 = __shfl_sync(FULL, w1, max(warp - 1, 0));
            const int bw2 = __shfl_sync(FULL, w2, max(warp - 1, 0));
            const int pw1 = __shfl_sync(FULL, w1, max(warp - 2, 0));
            const int pw2 = __shfl_sync(FULL, w2, max(warp - 2, 0));
            const int tot1 = __shfl_sync(FULL, w1, nw - 1);
            const int tot2 = __shfl_sync(FULL, w2, nw - 1);
            const int pre1 = warp > 1 ? pw1 : INT_MIN;
            const int pre2 = warp > 1 ? pw2 : INT_MIN;
            if (warp > 0) { ex1 = max(ex1, bw1); ex2 = max(ex2, bw2); }
            int g1 = max(carry1, ex1), g2 = max(carry2, ex2);
            int hv[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int j = j0 + x;
                int h = NEG;
                if (j <= L) {
                    h = hq[x];
                    if (j > 0) {
                        const int f1 = g1 - g - e * (j - 1);
                        const int f2 = g2 - q - c * (j - 1);
                        h = max(h, max(f1, f2));
                    }
                    g1 = max(g1, hq[x] + e * j);
                    g2 = max(g2, hq[x] + c * j);
                    rowbest = max(rowbest, h);
                }
                hv[x] = h;
            }
            if (inrow) {
                const int4 v = make_int4(hv[0], hv[1], hv[2], hv[3]);
                *(int4*)(Hi + j0) = v;
                if (RING) *(int4*)(ring + (size_t)slot * C + j0) = v;
            }
            if (RING) {
                // H at the column left of this thread's first, for the next
                // row: the left lane's last, or at a warp's first lane
                // rebuilt from the left warp's published prefix and Hq
                const int up = __shfl_up_sync(FULL, hv[3], 1);
                if (lane > 0) hleft_next = up;
                else if (warp > 0 && j0 <= L) {
                    const int jl = j0 - 1;
                    const int G1 = max(NEG, max(pre1, s_q1[buf][warp - 1]));
                    const int G2 = max(NEG, max(pre2, s_q2[buf][warp - 1]));
                    hleft_next = max(s_hq[buf][warp - 1],
                                     max(G1 - g - e * (jl - 1),
                                         G2 - q - c * (jl - 1)));
                }
            } else {
                carry1 = max(carry1, tot1);
                carry2 = max(carry2, tot2);
            }
            buf ^= 1;
        }
        if (rowbest > tbest) { tbest = rowbest; trow = i; }
        cur = nxt;
        hleft = hleft_next;
        if (!RING) __syncthreads();
    }
    // the end cell reads the last row's H at column L, which another
    // thread wrote after the last barrier
    if (RING) __syncthreads();

    // ---- end cell ----
    int ei, ej, best;
    if (local) {
        reduce_best(tbest, trow, s_rv, s_rr, nw);
        best = tbest;
        ei = trow;
        ej = 0;
    } else {
        int hb = INT_MIN, hr = INT_MAX;       // INT_MAX: no sink seen
        for (int i = 1 + tid; i <= V; i += NTB) {
            if (!tab.sink(i - 1)) continue;
            const int h = H[(size_t)i * C + L];
            if (h > hb) { hb = h; hr = i; }
        }
        reduce_best(hb, hr, s_rv, s_rr, nw);
        best = hb;
        ei = hr == INT_MAX ? 0 : hr;          // (a DAG always has a sink)
        ej = L;
    }
    if (warp != 0) return;

    // ---- traceback by value re-derivation (warp 0: every lane follows
    // the same path; lane 0 writes) ----
    int nm = 0, flag = 0;
    if (!local || best > 0) {
        if (local) {                          // first column holding best
            const int32_t* row = H + (size_t)ei * C;
            for (int c0 = 0; c0 <= L; c0 += 32) {
                const int j = c0 + lane;
                const unsigned hit =
                    __ballot_sync(FULL, j <= L && row[j] == best);
                if (hit) { ej = c0 + __ffs(hit) - 1; break; }
            }
        }
        const int lim = 2 * CW + 16;          // loop steps; V + L suffice
        int i = ei, j = ej, chan = 0;         // 0 H, 1 Hq, 2 E1, 3 E2
        int val = H[(size_t)i * C + j];
        for (int it = 0;; ++it) {
            if (it >= lim || nm >= CW) { flag = 2; break; }
            if (chan <= 1) {
                if (local && val == 0) break;
                if (i == 0) {
                    if (j == 0) break;
                    if (lane == 0) out[nm] = move_code(-1, j - 1);
                    ++nm;                     // leading insertion
                    --j;
                    val = H[j];
                    chan = 0;
                    continue;
                }
                if (j > 0) {
                    // a run of M steps read ahead, one a lane: lane t takes
                    // the step from (i - t, j - t) when that row's only
                    // predecessor is the row above (most are: tools/
                    // ring_reach.py), so 32 steps cost one round trip; the
                    // run ends at the first step that is not such an M move
                    const int r = i - lane, cl = j - lane;
                    const bool ok = r >= 1 && cl >= 1 && tab.np(r - 1) == 1
                                 && tab.pred(r - 1, 0) == r - 1;
                    if (__ballot_sync(FULL, ok) & 1) {
                        int h = 0, sv = 0;
                        if (ok) {
                            h = H[(size_t)(r - 1) * C + cl - 1];
                            sv = sqc(cl) == tab.base(r - 1) ? m : -n;
                        }
                        // the value at step t: val less the steps before
                        int vt = sv;
                        for (int o = 1; o < 32; o <<= 1) {
                            const int y = __shfl_up_sync(FULL, vt, o);
                            if (lane >= o) vt += y;
                        }
                        vt = val - (vt - sv);
                        const unsigned go = __ballot_sync(
                            FULL, ok && !(local && vt == 0) && h + sv == vt);
                        int run = __ffs(~go) ? __ffs(~go) - 1 : 32;
                        run = min(run, min(CW - nm, lim - it));
                        if (run > 0) {
                            if (lane < run)
                                out[nm + lane] = move_code(i - lane, j - lane - 1);
                            val = __shfl_sync(FULL, vt - sv, run - 1);
                            nm += run; it += run - 1;
                            i -= run; j -= run; chan = 0;
                            continue;
                        }
                    }
                }
                const int np = tab.np(i - 1);
                const size_t ri = (size_t)i * C + j;
                const int e1v = E1[ri], e2v = E2[ri];
                if (j > 0) {
                    const int subv = sqc(j) == tab.base(i - 1) ? m : -n;
                    int pr = -1;
                    for (int p0 = 0; p0 < np && pr < 0; p0 += 32) {
                        const int p = p0 + lane;
                        int u = 0, hit = 0;
                        if (p < np) {
                            u = tab.pred(i - 1, p);
                            hit = H[(size_t)u * C + j - 1] + subv == val;
                        }
                        const unsigned hm = __ballot_sync(FULL, hit);
                        if (hm) pr = __shfl_sync(FULL, u, __ffs(hm) - 1);
                    }
                    if (pr >= 0) {                // H there is val - subv
                        if (lane == 0) out[nm] = move_code(i, j - 1);
                        ++nm;
                        i = pr; --j; chan = 0;
                        val -= subv;
                        continue;
                    }
                }
                if (e1v == val) { chan = 2; continue; }
                if (e2v == val) { chan = 3; continue; }
                if (chan == 0) {
                    // nearest origin k < j, 32 columns a step
                    int kf = -1, hf = 0;
                    const int32_t* hqr = Hq + (size_t)i * C;
                    for (int k0 = j - 1; k0 >= 0 && kf < 0; k0 -= 32) {
                        const int k = k0 - lane;
                        int hit = 0, h = 0;
                        if (k >= 0) {
                            h = hqr[k];
                            hit = h - g - (j - 1 - k) * e == val ||
                                  h - q - (j - 1 - k) * c == val;
                        }
                        const unsigned hm = __ballot_sync(FULL, hit);
                        if (hm) {
                            kf = k0 - (__ffs(hm) - 1);
                            hf = __shfl_sync(FULL, h, __ffs(hm) - 1);
                        }
                    }
                    if (kf >= 0) {
                        if (nm + (j - kf) > CW) { flag = 2; break; }
                        for (int u = lane; u < j - kf; u += 32)
                            out[nm + u] = move_code(-1, j - 1 - u);
                        nm += j - kf;         // insertions
                        j = kf; chan = 1;
                        val = hf;             // Hq at the origin
                        continue;
                    }
                }
                flag = 1;                     // stuck: cannot happen
                break;
            }
            // E channel: this row's node is deleted from the sequence
            const int op = chan == 2 ? g : q, ex = chan == 2 ? e : c;
            const int32_t* Em = chan == 2 ? E1 : E2;
            const int np = tab.np(i - 1);
            if (lane == 0) out[nm] = move_code(i, -1);
            ++nm;
            // the first predecessor that opens the gap, else the first that
            // extends it; the step's value is the one that matched
            int nxt_h = -1, nxt_e = -1, val_h = 0, val_e = 0;
            for (int p0 = 0; p0 < np && nxt_h < 0; p0 += 32) {
                const int p = p0 + lane;
                int u = 0, hv = 0, ev = 0, hh = 0, he = 0;
                if (p < np) {
                    u = tab.pred(i - 1, p);
                    hv = H[(size_t)u * C + j];
                    ev = Em[(size_t)u * C + j];
                    hh = hv - op == val;
                    he = ev - ex == val;
                }
                const unsigned mh = __ballot_sync(FULL, hh);
                const unsigned me = __ballot_sync(FULL, he);
                if (mh) {
                    nxt_h = __shfl_sync(FULL, u, __ffs(mh) - 1);
                    val_h = __shfl_sync(FULL, hv, __ffs(mh) - 1);
                }
                if (me && nxt_e < 0) {
                    nxt_e = __shfl_sync(FULL, u, __ffs(me) - 1);
                    val_e = __shfl_sync(FULL, ev, __ffs(me) - 1);
                }
            }
            if (nxt_h >= 0) {
                i = nxt_h; chan = 0;
                val = val_h;
                continue;
            }
            if (nxt_e < 0) { flag = 1; break; }   // broken E chain
            i = nxt_e;
            val = val_e;
        }
    }
    if (lane == 0) {
        meta[4 * b] = nm; meta[4 * b + 1] = best;
        meta[4 * b + 2] = flag; meta[4 * b + 3] = 0;
    }
}

// How a launch lays out: `threads` a block (one task a block), rows in one
// tile with the ring (`ring` = 1) or in tiles, the sequence in shared
// memory (`seq_smem`), the row tables in shared memory (`tables`), the
// dynamic shared bytes and the blocks an SM holds.  Decided before the
// launch from the device's limits.
struct RoundGeometry {
    int threads, ring, seq_smem, tables, smem, per_sm;
};

template <bool R, bool T>
cudaError_t configure(const RoundGeometry& g, int* per_sm) {
    const cudaError_t err = opt_in_smem(poa_round_kernel<R, T>, g.smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, poa_round_kernel<R, T>, g.threads, g.smem);
}

template <bool R, bool T>
cudaError_t launch_round(const RoundGeometry& g, int B, const void* nv,
                         const void* slen, const void* par, const void* base,
                         const void* sink, const void* preds,
                         const void* seq, void* codes, void* meta,
                         void* scratch, int VW, int LS, int P, int local,
                         cudaStream_t stream) {
    poa_round_kernel<R, T><<<B, g.threads, g.smem, stream>>>(
        (const int32_t*)nv, (const int32_t*)slen, (const int32_t*)par,
        (const uint8_t*)base, (const uint8_t*)sink, (const int32_t*)preds,
        (const uint8_t*)seq, (int64_t*)codes, (int32_t*)meta,
        (int32_t*)scratch, VW, LS, P, local, g.seq_smem);
    return cudaGetLastError();
}

inline cudaError_t round_geometry(int VW, int LS, int P, RoundGeometry& g) {
    int dev = 0, smem_block = 0, smem_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return err;
    const int cols = LS + 1;
    int nt = ((cols + 3) / 4 + 31) & ~31;
    if (nt > MAX_NT) nt = MAX_NT;
    g.threads = nt;
    g.ring = cols <= TILE_MAX;
    g.seq_smem = g.ring || LS <= SMEM_SEQ_MAX;
    long budget = smem_sm - 1024;                // 1 KB per block reserved
    if (budget > smem_block) budget = smem_block;
    budget -= STATIC_SMEM;
    const size_t fixed = (g.ring ? ring_bytes(LS) : 0)
                       + (g.seq_smem ? align16((size_t)row_cols(LS) + 4) : 0);
    if ((long)fixed > budget) return cudaErrorInvalidValue;
    g.tables = VW <= ID16_MAX
            && (long)(fixed + table_bytes(VW, P)) <= budget;
    g.smem = (int)(fixed + (g.tables ? table_bytes(VW, P) : 0));
    return g.ring ? (g.tables ? configure<true, true>(g, &g.per_sm)
                              : configure<true, false>(g, &g.per_sm))
                  : (g.tables ? configure<false, true>(g, &g.per_sm)
                              : configure<false, false>(g, &g.per_sm));
}

}  // namespace

extern "C" {

// The launch geometry of tasks at these sizes on the current device: out
// = (threads a block, one-tile rows with the ring, sequence in shared
// memory, row tables in shared memory, dynamic shared bytes, blocks an
// SM).  Returns a CUDA error.
int poa_round_geometry(int VW, int LS, int P, int* out) {
    if (P < 1 || VW < 1 || LS < 1) return (int)cudaErrorInvalidValue;
    RoundGeometry g;
    const cudaError_t err = round_geometry(VW, LS, P, g);
    if (err == cudaSuccess) {
        out[0] = g.threads; out[1] = g.ring; out[2] = g.seq_smem;
        out[3] = g.tables; out[4] = g.smem; out[5] = g.per_sm;
    }
    return (int)err;
}

// Launch on `stream` (PyTorch's current stream), with `scratch` holding B
// tasks of task_words(VW, LS).  Returns cudaGetLastError() after the
// launch: nonzero means the launch was refused or an earlier asynchronous
// fault is pending, and the caller raises.
int poa_round_launch(const void* nv, const void* slen, const void* par,
                     const void* base, const void* sink, const void* preds,
                     const void* seq, void* codes, void* meta, void* scratch,
                     int B, int VW, int LS, int P, int local, void* stream) {
    if (B <= 0) return 0;
    if (P < 1 || VW < 1 || LS < 1) return (int)cudaErrorInvalidValue;
    RoundGeometry g;
    const cudaError_t err = round_geometry(VW, LS, P, g);
    if (err != cudaSuccess) return (int)err;
    auto fn = g.ring ? (g.tables ? launch_round<true, true>
                                 : launch_round<true, false>)
                     : (g.tables ? launch_round<false, true>
                                 : launch_round<false, false>);
    return (int)fn(g, B, nv, slen, par, base, sink, preds, seq, codes, meta,
                   scratch, VW, LS, P, local, (cudaStream_t)stream);
}

}  // extern "C"
