// poa_batch.cu — the batched per-round POA DP of `--engine jax` on Hopper
// (sm_90a): for each task of a batch, one sequence against one POA graph,
// the DP fill in topological row order and a traceback through stored
// backpointers.
//
// It replaces the jitted XLA function of the JAX package's batched engine,
// smoothxg_tpu/ops/poa_jax.py:_make_fn (`fill_and_trace`, :169), and
// computes the same outputs from the same inputs (that function's layout):
//   base   (Vp, B)     int32  base of row v + 1 (topological rows)
//   pred   (Vp, B, P)  int32  predecessor rows of row v + 1 (0 = the
//                             virtual source), unused slots repeat slot 0
//   seq    (B, Lp)     int32  the sequence (-1 past slen)
//   slen, nvalid (B,)  int32  L and V of each task
//   sink   (B, Vp + 1) uint8  1 for rows whose node has no successor
//   par    (B, 6)      int32  m, n, g, e, q, c
// returns out (B, S, 2) int32 (S = Vp + Lp + 5; the moves (row or -1,
// column or -1) from the end back to the start, -9 past them), outpos (B,)
// the move count and bv (B,) the best score.  Scores are int32 with the
// floor NEG = -2^30: where the XLA function works in int16 (local tasks of
// a bucket up to 8,199 columns) it equals this kernel unless its G = hq +
// e * j wraps (ROADMAP C9).
//
// The tie rules are the XLA function's, each kept exactly:
//   * predecessor maxima take the first slot (strict > in slot order; a
//     slot repeating an earlier row can never win, so only the first
//     occurrence of each row is read);
//   * E opens win ties against extends;
//   * kind is checked as zero (local), M, E1, E2, hsel as Hq, F1, F2;
//   * the F origin is the later column on ties of the prefix max: keys
//     (value << 32 | column) under a plain int64 max;
//   * the local best is the first row, then the first column, by strict >;
//     the global best the first row with the largest H at column slen
//     among sink rows (others count as NEG);
//   * the traceback is the lockstep state machine of five channels (H, Hq,
//     E1, E2, F), at most 2 * S steps, an M move two of them.
//
// What bounds it on this card: every row reads rows above it, so a task's
// rows run one after another and only a row's L + 1 columns are parallel;
// the traceback is a chain of dependent reads.  A launch holds ~60 tasks on
// the main path, fewer than the SMs, so what matters is one task's latency.
//
// The design (a thread block a task; `batch_geometry` below):
//   * the block is sized to the launch's row: each thread owns 4
//     consecutive columns (one int4), ceil((Lp + 1) / 4) threads rounded up
//     to a warp, at most MAX_NT; rows longer than 4 MAX_NT columns are
//     walked in tiles, the F prefix carried from tile to tile;
//   * the row tables are staged once, before the fill, a row a thread: the
//     distinct predecessor rows in slot order, a mask of the slots that
//     first name each, and the base; in shared memory (rows as int16) when
//     they fit, else in the task's device scratch (int32).  No list is built
//     on the row chain;
//   * where a row is one tile, the last RING_ROWS rows of H, E1 and E2 sit
//     in a ring in shared memory, so a predecessor within 7 rows is read
//     from it; device memory keeps H, E1 and E2 only of rows that a row 8 or
//     more below reads (marked while staging), and every row's
//     backpointers;
//   * such rows take no block barrier: the warps run as a wavefront.  A
//     warp reads the ring only at its own columns; the F prefix through its
//     left neighbour's last column comes from what that warp publishes for
//     the row (a flag, then the prefix, PUB_ROWS rows deep), and H at the
//     column left of a thread's first from its left lane by a shuffle or,
//     at a warp's first lane, rebuilt from the published prefix and Hq
//     (`hleft`) or read from the left warp's edge buffer (its last column,
//     EDGE_ROWS rows deep).  A warp reuses a publish slot only once the
//     right warp has read it, so no warp runs more than PUB_ROWS rows ahead;
//   * the F scan is one of int32 values (the maxima of Hq + ext * column);
//     each cell keeps in device memory its packed backpointers T0 = hqbp |
//     hsel << 8 | e1bp << 16 | e2bp << 24 and its Hq, from which the
//     traceback finds an F origin, the XLA function's key max, where it
//     takes an F step;
//   * the traceback runs in warp 0: a run of M moves, each through slot 0
//     to the row's first predecessor, is read ahead, lane t the step t
//     rows down that chain of the tables and t columns left, and taken up
//     to the first step that is not one (a ballot); runs of F and leading
//     insertions are written a lane a move; every other step is the state
//     machine's, one at a time.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "smem.cuh"

// Timing-only switches (smoothxg_tpu_torch/tools/batch_cuts.py), 0 as
// built: bit 1 no traceback, bit 2 no block-wide F scan (each thread's own
// columns only) — their outputs are invalid by design; bit 4 the tiled
// route for every row (no ring), bit 8 the row tables in device memory,
// bit 16 one block an SM (shared memory padded) — these keep the outputs.
#ifndef BATCH_CUTS
#define BATCH_CUTS 0
#endif

namespace {

constexpr int32_t NEG = -(1 << 30);   // score floor (csrc/host/cpoa.cpp)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NT = 512;           // threads a block at most
constexpr int MAX_WARPS = MAX_NT / 32;
constexpr int TILE_MAX = 4 * MAX_NT;  // columns of one tile at most
constexpr int RING_ROWS = 8;          // rows of H, E1, E2 in shared memory
constexpr int MAXP = 16;              // predecessor slots (4-bit codes)
constexpr int MAXL = 65535;           // F origins are 16-bit columns
constexpr int ID16_MAX = 32767;       // node rows that fit an int16
constexpr int STATIC_SMEM = 512;      // the kernel's static buffers
constexpr int PUB_ROWS = 4;           // rows of a warp's published prefixes
constexpr int EDGE_ROWS = 16;         // rows of a warp's last column of H
constexpr long long KEY_NONE = LLONG_MIN;  // an empty prefix

__host__ __device__ inline int row_cols(int Lp) {   // stored columns a row
    return (Lp + 4) & ~3;
}

__host__ __device__ inline size_t align16(size_t x) {
    return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline long long plane_words(int Vp, int Lp) {
    return ((long long)Vp + 1) * row_cols(Lp);
}

// int32 words of the row tables in device memory: rows (Vp x MAXP), slot
// masks, bases, then the far bits (a bit a row)
__host__ __device__ inline long long dtab_words(int Vp) {
    return ((long long)(MAXP + 2) * Vp + (Vp + 31) / 32 + 3) & ~3LL;
}

// shared bytes of the row tables: int16 rows (P a row), uint16 slot masks,
// int32 bases, the far bits
__host__ __device__ inline size_t table_bytes(int Vp, int P) {
    return align16(2 * (size_t)Vp * P) + align16(2 * (size_t)Vp) +
           align16(4 * (size_t)Vp) + align16(4 * (size_t)((Vp + 31) / 32));
}

__host__ __device__ inline int block_threads(int Lp) {
    const int nt = (row_cols(Lp) / 4 + 31) & ~31;
    return nt < MAX_NT ? nt : MAX_NT;
}

// the ring, then each warp's published prefixes (5 words a row) and its
// last column of H
__host__ __device__ inline size_t ring_bytes(int Lp) {
    const size_t nw = block_threads(Lp) / 32;
    return 3 * (size_t)RING_ROWS * row_cols(Lp) * 4 +
           nw * (PUB_ROWS * 5 + EDGE_ROWS) * 4;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
    return *reinterpret_cast<const volatile int*>(p);
}

// spin-wait hint: nothing on the card (the CPU emulation yields)
#ifndef SPIN_PAUSE
#define SPIN_PAUSE()
#endif

// Wait until another warp's flag reaches v.  A handoff that never comes
// is a fault of the kernel: the launch fails instead of hanging.
__device__ __forceinline__ void wait_flag(const int* f, int v) {
    for (unsigned n = 0; ld_volatile(f) < v; ++n) {
        if (n > (1u << 26)) __trap();
        SPIN_PAUSE();
    }
}

__device__ __forceinline__ long long lmax(long long a, long long b) {
    return a > b ? a : b;
}

// (value, column) as one int64 whose max is the max value, ties to the
// later column
__device__ __forceinline__ long long key_of(int v, int col) {
    return (long long)(((unsigned long long)(long long)v << 32) |
                       (unsigned)col);
}

// The task's row tables; table row r is DP row r + 1.  TSMEM: in shared
// memory with int16 rows, else in device scratch with int32 rows.
template <bool TSMEM>
struct RowTab {
    int16_t* r16;
    uint16_t* m16;
    int32_t* r32;
    int32_t* m32;
    int32_t* base;
    unsigned* far;
    int P;
    // the t-th distinct predecessor row
    __device__ __forceinline__ int row(int r, int t) const {
        if constexpr (TSMEM) return r16[(size_t)r * P + t];
        else return r32[(size_t)r * P + t];
    }
    // bit k: slot k is the first to name its row
    __device__ __forceinline__ unsigned mask(int r) const {
        if constexpr (TSMEM) return m16[r]; else return (unsigned)m32[r];
    }
    // the predecessor row in slot s, a slot that first names its row
    __device__ __forceinline__ int slot_row(int r, int s) const {
        return row(r, __popc(mask(r) & ((1u << s) - 1)));
    }
    __device__ __forceinline__ bool is_far(int r) const {
        return (far[r >> 5] >> (r & 31)) & 1;
    }
};

// a DP row's tables, loaded one row ahead: slot mask, base, whether rows 8
// or more below read it, the first four predecessor rows (a row with more
// reads the rest in the loop)
struct RowMeta {
    unsigned mask;
    int bv, far, pr[4];
};

template <bool TSMEM>
__device__ __forceinline__ RowMeta row_meta(const RowTab<TSMEM>& tab, int r) {
    RowMeta m;
    m.mask = tab.mask(r);
    m.bv = tab.base[r];
    m.far = tab.is_far(r);
#pragma unroll
    for (int p = 0; p < 4; ++p) m.pr[p] = p < tab.P ? tab.row(r, p) : 0;
    return m;
}

// max value, ties to the smaller index, over the block; the result lands
// in every thread
template <typename I>
__device__ void reduce_best(int& v, I& r, int* sv, I* sr, int nw) {
    for (int o = 16; o; o >>= 1) {
        const int ov = __shfl_down_sync(FULL, v, o);
        const I orr = __shfl_down_sync(FULL, r, o);
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

// The kernel.  RING: every row is one tile, the last RING_ROWS rows sit
// in shared memory and the warps run as a wavefront; else rows are walked
// in tiles of 4 blockDim.x columns with predecessor rows from device
// memory (a barrier a tile and one a row).  TSMEM: the row tables in shared
// memory.
template <bool RING, bool TSMEM>
__global__ void __launch_bounds__(MAX_NT, 1) poa_batch_kernel(
    const int* __restrict__ base, const int* __restrict__ pred,
    const int* __restrict__ seq, const int* __restrict__ slen,
    const int* __restrict__ nvalid, const uint8_t* __restrict__ sink,
    const int* __restrict__ par, int* __restrict__ out,
    int* __restrict__ outpos, int* __restrict__ bvout, int* scratch, int B,
    int Vp, int Lp, int P, int local) {
    // dynamic: the ring (RING), then the row tables (TSMEM), each part
    // 16-byte aligned
    extern __shared__ int4 s_dyn[];
    // the tiled route's scan buffers (two, alternating), then the end
    // cell's reduction; each warp's last published row (ring route)
    __shared__ long long s_wbuf[2 * MAX_WARPS];
    __shared__ int s_flag[MAX_WARPS];
    int (*s_w1)[MAX_WARPS] = reinterpret_cast<int (*)[MAX_WARPS]>(s_wbuf);
    int (*s_w2)[MAX_WARPS] = s_w1 + 2;
    int* s_rv = reinterpret_cast<int*>(s_wbuf);
    long long* s_ri = s_wbuf + MAX_WARPS;

    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int NTB = blockDim.x, nw = NTB >> 5;
    const int V = min(max(nvalid[b], 0), Vp);
    const int L = min(max(slen[b], 0), Lp);
    const int* pb = par + 6LL * b;
    const int m = pb[0], n = pb[1], g = pb[2], e = pb[3], q = pb[4],
              c = pb[5];
    const int C = row_cols(Lp);
    const long long plane = plane_words(Vp, Lp);
    int* Hd = scratch + (long long)b * (5 * plane + dtab_words(Vp));
    int* E1d = Hd + plane;
    int* E2d = E1d + plane;
    unsigned* T0d = reinterpret_cast<unsigned*>(E2d + plane);
    int* Qd = reinterpret_cast<int*>(T0d + plane);
    int* dtab = Hd + 5 * plane;
    const int* sq = seq + (long long)b * Lp;
    const int S = Vp + Lp + 5;
    int* ob = out + 2LL * S * b;

    int8_t* sm = reinterpret_cast<int8_t*>(s_dyn);
    int* ring = reinterpret_cast<int*>(sm);       // [3][RING_ROWS][C]
    // RING: warp w's prefixes of row v at s_pub[(w * PUB_ROWS + v %
    // PUB_ROWS) * 5]: through its last column (F1, F2 terms), through the
    // column before its last (F1, F2), Hq at its last; its last column of H
    // of row v at s_edge[w * EDGE_ROWS + v % EDGE_ROWS]
    int* s_pub = ring + 3 * RING_ROWS * C;
    int* s_edge = s_pub + nw * PUB_ROWS * 5;
    int8_t* s_tab = sm + (RING ? ring_bytes(Lp) : 0);
    RowTab<TSMEM> tab;
    tab.P = P;
    if constexpr (TSMEM) {
        tab.r16 = reinterpret_cast<int16_t*>(s_tab);
        tab.m16 = reinterpret_cast<uint16_t*>(
            s_tab + align16(2 * (size_t)Vp * P));
        tab.base = reinterpret_cast<int32_t*>(
            reinterpret_cast<int8_t*>(tab.m16) + align16(2 * (size_t)Vp));
        tab.far = reinterpret_cast<unsigned*>(
            reinterpret_cast<int8_t*>(tab.base) + align16(4 * (size_t)Vp));
    } else {
        tab.r32 = dtab;
        tab.m32 = dtab + (long long)MAXP * Vp;
        tab.base = tab.m32 + Vp;
        tab.far = reinterpret_cast<unsigned*>(tab.base + Vp);
    }

    for (int k = tid; k < 2 * S; k += NTB) ob[k] = -9;
    if (RING && tid < nw) {
        s_flag[tid] = 0;
        const int col = 128 * tid + 127;
        int h = NEG;
        if (col <= L)
            h = local ? 0 : max(-(g + (col - 1) * e), -(q + (col - 1) * c));
        s_edge[tid * EDGE_ROWS] = h;
    }
    for (int w = tid; w < (V + 31) / 32; w += NTB) tab.far[w] = 0;
    // row 0, the virtual source: H is 0 (local) or the leading-gap row
    for (int col = tid; col < C; col += NTB) {
        int h = NEG;
        if (col <= L) {
            h = 0;
            if (!local && col > 0)
                h = max(-(g + (col - 1) * e), -(q + (col - 1) * c));
        }
        Hd[col] = h; E1d[col] = NEG; E2d[col] = NEG; T0d[col] = 0;
        if (RING) {
            ring[col] = h;
            ring[RING_ROWS * C + col] = NEG;
            ring[2 * RING_ROWS * C + col] = NEG;
        }
    }
    __syncthreads();                 // the far bits are clear

    // ---- stage the row tables, a row a thread: the distinct predecessor
    // rows in slot order and the slots that first name them; mark the rows
    // that a row 8 or more below reads ----
    for (int r = tid; r < V; r += NTB) {
        const int* pr = pred + ((long long)r * B + b) * P;
        int x[MAXP];
#pragma unroll
        for (int k = 0; k < MAXP; ++k) x[k] = k < P ? pr[k] : 0;
        unsigned msk = 0;
#pragma unroll
        for (int k = 0; k < MAXP; ++k) {
            bool first = k < P;
#pragma unroll
            for (int t = 0; t < k; ++t) first &= x[t] != x[k];
            if (first) {
                msk |= 1u << k;
                // row r + 1 reads row x[k]: far when 8 or more rows back
                const int u = x[k];
                if (RING && r + 1 - u >= RING_ROWS && u >= 1 && u <= V)
                    atomicOr(&tab.far[(u - 1) >> 5], 1u << ((u - 1) & 31));
            }
        }
        int t = 0;
#pragma unroll
        for (int k = 0; k < MAXP; ++k)
            if ((msk >> k) & 1) {
                if constexpr (TSMEM) tab.r16[(size_t)r * P + t] = (int16_t)x[k];
                else tab.r32[(size_t)r * P + t] = x[k];
                ++t;
            }
        if constexpr (TSMEM) tab.m16[r] = (uint16_t)msk;
        else tab.m32[r] = (int)msk;
        tab.base[r] = base[(long long)r * B + b];
    }
    __syncthreads();

    // ---- DP fill, a row per topological position ----
    // the local best of this thread's cells: the largest H, the first row
    // and then the first column among equal ones (the XLA function's row
    // scan with a strict >, reduced over the block once, after the fill)
    int tv = INT_MIN;
    long long tcell = LLONG_MAX;
    int buf = 0;
    const int TILE = 4 * NTB;
    int sqv[4];                      // the sequence at columns j0 .. j0 + 3
    auto load_seq = [&](int j0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int col = j0 + k;
            sqv[k] = col >= 1 && col <= L ? sq[col - 1] : 0;
        }
    };
    if (RING) load_seq(4 * tid);
    // H of the previous row at the column left of this thread's first
    // (RING: another warp's, for a warp's first lane)
    int hleft = NEG;
    if (RING && tid > 0 && 4 * tid - 1 <= L)
        hleft = local ? 0 : max(-(g + (4 * tid - 2) * e),
                                -(q + (4 * tid - 2) * c));
    RowMeta cur, nxt;
    if (V > 0) cur = row_meta(tab, 0);
    nxt = cur;
    for (int v = 1; v <= V; ++v) {
        if (v < V) nxt = row_meta(tab, v);
        const int np = __popc(cur.mask);
        // full rows to device memory where a row 8 or more below reads
        // this one (every row on the tiled route); else only column L, for
        // the global best
        const bool full = !RING || cur.far;
        int carry1 = INT_MIN, carry2 = INT_MIN;
        const int slot = v & (RING_ROWS - 1);
        int hleft_next = NEG;
        for (int t0 = 0; t0 <= L; t0 += TILE) {
            const int j0 = t0 + 4 * tid;
            const bool inrow = j0 < C;       // the int4 lies in the row
            if (!RING) load_seq(j0);
            // predecessor maxima: H at columns j0 - 1 .. j0 + 3 (index k is
            // column j0 - 1 + k), E1 and E2 at j0 .. j0 + 3, each with the
            // first slot that reaches it
            int hm[5], ha[5], x1m[4], x1a[4], x2m[4], x2a[4];
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                hm[k] = INT_MIN; ha[k] = 0;
                if (k < 4) { x1m[k] = INT_MIN; x1a[k] = 0;
                             x2m[k] = INT_MIN; x2a[k] = 0; }
            }
            unsigned slots = cur.mask;
            // (the first predecessor, slot 0, sets the maxima outright)
            auto take = [&](int pr, bool first) {
                const int sl = __ffs(slots) - 1;
                slots &= slots - 1;
                const int d = v - pr;
                int4 h = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
                int4 y1 = h, y2 = h;
                int hl = INT_MIN;
                if (RING && d < RING_ROWS) {
                    const int s = pr & (RING_ROWS - 1);
                    if (inrow) {
                        h = *reinterpret_cast<const int4*>(
                            ring + (size_t)s * C + j0);
                        y1 = *reinterpret_cast<const int4*>(
                            ring + (size_t)(RING_ROWS + s) * C + j0);
                        y2 = *reinterpret_cast<const int4*>(
                            ring + (size_t)(2 * RING_ROWS + s) * C + j0);
                    }
                    if (lane == 0 && j0 > 0 && inrow)
                        hl = d == 1 ? hleft
                           : s_edge[(warp - 1) * EDGE_ROWS +
                                    (pr & (EDGE_ROWS - 1))];
                } else {
                    const long long rb = (long long)pr * C + j0;
                    if (inrow) {
                        h = *reinterpret_cast<const int4*>(Hd + rb);
                        y1 = *reinterpret_cast<const int4*>(E1d + rb);
                        y2 = *reinterpret_cast<const int4*>(E2d + rb);
                    }
                    if (lane == 0 && j0 > 0 && inrow) hl = Hd[rb - 1];
                }
                // the column left of this thread's first is the left
                // lane's last (a warp's first lane read it above)
                const int up = __shfl_up_sync(FULL, h.w, 1);
                if (lane > 0) hl = up;
                const int hv[5] = {hl, h.x, h.y, h.z, h.w};
                const int v1[4] = {y1.x, y1.y, y1.z, y1.w};
                const int v2[4] = {y2.x, y2.y, y2.z, y2.w};
#pragma unroll
                for (int k = 0; k < 5; ++k) {
                    if (first || hv[k] > hm[k]) { hm[k] = hv[k]; ha[k] = sl; }
                    if (k < 4 && (first || v1[k] > x1m[k])) {
                        x1m[k] = v1[k]; x1a[k] = sl;
                    }
                    if (k < 4 && (first || v2[k] > x2m[k])) {
                        x2m[k] = v2[k]; x2a[k] = sl;
                    }
                }
            };
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                if (p >= np) break;
                take(cur.pr[p], p == 0);
            }
            for (int p = 4; p < np; ++p) take(tab.row(v - 1, p), false);

            int hq[4], e1[4], e2[4];
            unsigned w0[4];
            // the thread's maxima of Hq + ext * column, the F scan's terms
            int t1 = INT_MIN, t2 = INT_MIN;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int col = j0 + k;
                hq[k] = NEG; e1[k] = NEG; e2[k] = NEG; w0[k] = 0;
                if (col > L) continue;
                int M = NEG, mp = 0;
                if (col > 0) {
                    M = hm[k] + (sqv[k] == cur.bv ? m : -n);
                    mp = ha[k];
                }
                const int h = hm[k + 1], pa = ha[k + 1];
                const int o1 = h - g, x1 = x1m[k] - e;
                const int o2 = h - q, x2 = x2m[k] - c;
                e1[k] = max(max(o1, x1), NEG);
                e2[k] = max(max(o2, x2), NEG);
                const int e1bp = o1 >= x1 ? (16 | pa) : x1a[k];
                const int e2bp = o2 >= x2 ? (16 | pa) : x2a[k];
                int hv = max(M, max(e1[k], e2[k]));
                int kind;
                if (local) {
                    hv = max(hv, 0);
                    kind = hv == 0 ? 3 : M == hv ? 0 : e1[k] == hv ? 1 : 2;
                } else {
                    kind = M == hv ? 0 : e1[k] == hv ? 1 : 2;
                }
                const int kp = kind == 0 ? mp
                             : kind == 1 ? (e1bp & 15) : (e2bp & 15);
                hq[k] = hv;
                w0[k] = (unsigned)((kind << 4) | kp) |
                        ((unsigned)e1bp << 16) | ((unsigned)e2bp << 24);
                t1 = max(t1, hv + e * col);
                t2 = max(t2, hv + c * col);
            }

            // the F scan: F(j) = max over k < j of Hq(k) + ext * k, less
            // open + ext * (j - 1), a warp-shuffle inclusive scan of the
            // thread maxima, then across warps.  RING: each warp takes the
            // prefix through its left neighbour's last column from what that
            // warp published for this row, and publishes its own, so warps
            // run rows apart without a block barrier.  Tiled: the warp totals
            // through shared memory (double buffered, so one barrier
            // serves).  The F origins are not kept: the traceback finds them
            // again (the XLA function's key max).
            int ex1, ex2;
            int pre1 = INT_MIN, pre2 = INT_MIN, preq = NEG;
#if BATCH_CUTS & 2
            // timing cut: each thread's own columns (tiled: the barrier kept)
            ex1 = ex2 = INT_MIN;
            if (!RING) __syncthreads();
#else
            int i1 = t1, i2 = t2;
            for (int o = 1; o < 32; o <<= 1) {
                const int y1 = __shfl_up_sync(FULL, i1, o);
                const int y2 = __shfl_up_sync(FULL, i2, o);
                if (lane >= o) { i1 = max(i1, y1); i2 = max(i2, y2); }
            }
            ex1 = __shfl_up_sync(FULL, i1, 1);
            ex2 = __shfl_up_sync(FULL, i2, 1);
            if (lane == 0) { ex1 = INT_MIN; ex2 = INT_MIN; }
            if constexpr (RING) {
                // the left warp's prefix of this row through its last column
                // (and, for the first lane, through the column before, and
                // Hq there)
                int l1 = INT_MIN, l2 = INT_MIN;
                if (warp > 0) {
                    wait_flag(&s_flag[warp - 1], v);
                    __threadfence_block();
                    const int* pub = s_pub +
                        ((warp - 1) * PUB_ROWS + (v & (PUB_ROWS - 1))) * 5;
                    l1 = ld_volatile(pub);
                    l2 = ld_volatile(pub + 1);
                    if (lane == 0) {
                        pre1 = ld_volatile(pub + 2);
                        pre2 = ld_volatile(pub + 3);
                        preq = ld_volatile(pub + 4);
                    }
                }
                __syncwarp();
                if (lane == 31) {
                    if (warp + 1 < nw) {
                        // the slot's previous row must have been read
                        wait_flag(&s_flag[warp + 1], v - PUB_ROWS);
                        int a1 = max(l1, ex1), a2 = max(l2, ex2);
#pragma unroll
                        for (int k = 0; k < 3; ++k)
                            if (j0 + k <= L) {
                                a1 = max(a1, hq[k] + e * (j0 + k));
                                a2 = max(a2, hq[k] + c * (j0 + k));
                            }
                        volatile int* pub = s_pub +
                            (warp * PUB_ROWS + (v & (PUB_ROWS - 1))) * 5;
                        pub[0] = max(l1, i1); pub[1] = max(l2, i2);
                        pub[2] = a1; pub[3] = a2; pub[4] = hq[3];
                    }
                    __threadfence_block();
                    *reinterpret_cast<volatile int*>(&s_flag[warp]) = v;
                }
                ex1 = max(ex1, l1);
                ex2 = max(ex2, l2);
            } else {
                if (lane == 31) { s_w1[buf][warp] = i1; s_w2[buf][warp] = i2; }
                __syncthreads();
                // the warp totals' inclusive prefix max, lane w holding
                // warps 0..w; from it the max over the warps before this one
                // (into ex) and over all (into the carry)
                int w1 = lane < nw ? s_w1[buf][lane] : INT_MIN;
                int w2 = lane < nw ? s_w2[buf][lane] : INT_MIN;
                for (int o = 1; o < nw; o <<= 1) {
                    const int y1 = __shfl_up_sync(FULL, w1, o);
                    const int y2 = __shfl_up_sync(FULL, w2, o);
                    if (lane >= o) { w1 = max(w1, y1); w2 = max(w2, y2); }
                }
                const int bw1 = __shfl_sync(FULL, w1, max(warp - 1, 0));
                const int bw2 = __shfl_sync(FULL, w2, max(warp - 1, 0));
                const int all1 = __shfl_sync(FULL, w1, nw - 1);
                const int all2 = __shfl_sync(FULL, w2, nw - 1);
                if (warp > 0) { ex1 = max(ex1, bw1); ex2 = max(ex2, bw2); }
                ex1 = max(ex1, carry1);
                ex2 = max(ex2, carry2);
                carry1 = max(carry1, all1);
                carry2 = max(carry2, all2);
                buf ^= 1;
            }
#endif
            int hv[4];
            unsigned w0s[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int col = j0 + k;
                hv[k] = NEG; w0s[k] = 0;
                if (col > L) continue;
                // no prefix (column 0): F is NEG
                const int F1 = ex1 == INT_MIN ? NEG : ex1 - g - e * (col - 1);
                const int F2 = ex2 == INT_MIN ? NEG : ex2 - q - c * (col - 1);
                ex1 = max(ex1, hq[k] + e * col);
                ex2 = max(ex2, hq[k] + c * col);
                const int H = max(hq[k], max(F1, F2));
                const unsigned hsel = H == hq[k] ? 0u : H == F1 ? 1u : 2u;
                hv[k] = H;
                w0s[k] = w0[k] | hsel << 8;
                if (local && H > tv) {
                    tv = H;
                    tcell = (long long)v * C + col;
                }
            }
            if (inrow) {
                const long long rb = (long long)v * C + j0;
                const int4 vh = make_int4(hv[0], hv[1], hv[2], hv[3]);
                const int4 v1 = make_int4(e1[0], e1[1], e1[2], e1[3]);
                const int4 v2 = make_int4(e2[0], e2[1], e2[2], e2[3]);
                *reinterpret_cast<int4*>(T0d + rb) = make_int4(
                    (int)w0s[0], (int)w0s[1], (int)w0s[2], (int)w0s[3]);
                *reinterpret_cast<int4*>(Qd + rb) =
                    make_int4(hq[0], hq[1], hq[2], hq[3]);
                if (full) {
                    *reinterpret_cast<int4*>(Hd + rb) = vh;
                    *reinterpret_cast<int4*>(E1d + rb) = v1;
                    *reinterpret_cast<int4*>(E2d + rb) = v2;
                } else if (!local && L >= j0 && L < j0 + 4) {
                    const int x = L - j0;     // (no dynamic index: a stack)
                    Hd[(long long)v * C + L] = x == 0 ? hv[0] : x == 1 ? hv[1]
                                             : x == 2 ? hv[2] : hv[3];
                }
                if (RING) {
                    *reinterpret_cast<int4*>(ring + (size_t)slot * C + j0) = vh;
                    *reinterpret_cast<int4*>(
                        ring + (size_t)(RING_ROWS + slot) * C + j0) = v1;
                    *reinterpret_cast<int4*>(
                        ring + (size_t)(2 * RING_ROWS + slot) * C + j0) = v2;
                }
            }
            if (RING) {
                // H at the column left of this thread's first, for the next
                // row: the left lane's last, or at a warp's first lane
                // rebuilt from the left warp's published prefix and Hq; a
                // warp's last column for the next warp's rows to come
                const int up = __shfl_up_sync(FULL, hv[3], 1);
                if (lane > 0) hleft_next = up;
                else if (warp > 0 && j0 <= L) {
                    const int jl = j0 - 1;
                    const int F1 = pre1 == INT_MIN ? NEG
                                 : pre1 - g - e * (jl - 1);
                    const int F2 = pre2 == INT_MIN ? NEG
                                 : pre2 - q - c * (jl - 1);
                    hleft_next = max(preq, max(F1, F2));
                }
                if (lane == 31)
                    s_edge[warp * EDGE_ROWS + (v & (EDGE_ROWS - 1))] = hv[3];
            }
        }
        cur = nxt;
        hleft = hleft_next;
        if (!RING) __syncthreads();  // row v is read by the rows after it
    }
    // the end cell and the traceback read the last row, which other
    // threads wrote after the last barrier
    __syncthreads();

    int bv = NEG, bi = 0, bj = 0;
    if (local) {
        // max value, ties to the smaller cell index (row, then column)
        reduce_best(tv, tcell, s_rv, s_ri, nw);
        if (tv > NEG) { bv = tv; bi = (int)(tcell / C); bj = (int)(tcell % C); }
    } else {
        // the first row with the largest H at column L; rows that are no
        // sink count as NEG, so with no sink it is row 0
        int hv = INT_MIN;
        long long hr = LLONG_MAX;
        for (int r = tid; r <= V; r += NTB) {
            const int x = sink[(long long)b * (Vp + 1) + r]
                              ? Hd[(long long)r * C + L] : NEG;
            if (x > hv || (x == hv && r < hr)) { hv = x; hr = r; }
        }
        reduce_best(hv, hr, s_rv, s_ri, nw);
        bv = hv; bi = (int)hr; bj = L;
    }
    if (warp != 0) return;
#if BATCH_CUTS & 1
    if (lane == 0) { outpos[b] = 0; bvout[b] = bv; }
    return;
#endif

    // ---- traceback (warp 0): the XLA function's state machine, channels
    // 0 = H, 1 = Hq, 2 = E1, 3 = E2, 4 = F; every lane follows the same
    // path, lane t writes the moves of a run that fall to it ----
    const int lim = 2 * S;
    int i = bi, j = bj, chan = 0, ftgt = 0, op = 0, it = 0;
    bool done = local ? bv <= 0 : false;
    // the predecessor row in slot s of row r (the input's row past V)
    auto pred_at = [&](int r, int s) -> int {
        return r <= V ? tab.slot_row(r - 1, s)
                      : pred[((long long)(r - 1) * B + b) * P + s];
    };
    auto emit = [&](int k, int row, int col) {
        if (op + k < S) { ob[2 * (op + k)] = row; ob[2 * (op + k) + 1] = col; }
    };
    int cr = -1, cj = 0;             // the cell whose T0 word is in cw
    unsigned cw = 0;
    while (!done && it < lim) {
        if (chan == 0 && i >= 1) {
            // a run of M moves along first predecessors, read ahead: lane
            // t takes the step at (r_t, j - t), r_0 = i and r_t + 1 the
            // first predecessor row of r_t (slot 0's), walked in the
            // tables; the step is such an M move when its cell came from Hq
            // (hsel 0) by M (kind 0) through slot 0, and the run is the
            // steps up to the first that is not
            int rr = i, r = i, after = 0;
            for (int t = 1; t <= 32; ++t) {
                rr = rr >= 1 && rr <= V ? tab.row(rr - 1, 0) : 0;
                if (lane == t) r = rr;
                if (t == 32) after = rr;
            }
            const int cl = j - lane;
            bool ok = false;
            if (r >= 1 && r <= V && cl >= 1)
                ok = (T0d[(long long)r * C + cl] & 0xffffu) == 0;
            const unsigned go = __ballot_sync(FULL, ok);
            const int run = min(go == FULL ? 32 : __ffs(~go) - 1,
                                (lim - it) / 2);
            if (run > 0) {
                if (lane < run) emit(lane, r, j - lane - 1);
                const int next = __shfl_sync(FULL, r, run & 31);
                op += run; it += 2 * run;
                i = run == 32 ? after : next; j -= run;
                continue;
            }
        }
        const bool i0 = i == 0;
        if (chan == 4 && j > ftgt) {
            // F insertions down to the origin, a move an iteration
            const int k = min(j - ftgt, lim - it);
            for (int u = lane; u < k; u += 32) emit(u, -1, j - 1 - u);
            op += k; it += k; j -= k;
            continue;
        }
        if (!local && chan <= 1 && i0 && j > 0) {
            // leading insertions through the source row
            const int k = min(j, lim - it);
            for (int u = lane; u < k; u += 32) emit(u, -1, j - 1 - u);
            op += k; it += k; j -= k;
            chan = 0;
            continue;
        }
        // one step of the state machine
        const bool in_H = chan == 0 && !i0, in_HQ = chan == 1 && !i0;
        const bool in_E1 = chan == 2, in_E2 = chan == 3, in_F = chan == 4;
        const bool at_src = chan <= 1 && i0;
        // the tables of row max(i, 1) (the XLA function reads row index
        // max(i - 1, 0) of its tables, which start at row 1)
        const int r = max(i, 1);
        unsigned t0w = 0;
        if ((in_H || in_HQ || in_E1 || in_E2) && r <= V) {
            if (r != cr || j != cj) {
                cw = T0d[(long long)r * C + j];
                cr = r; cj = j;
            }
            t0w = cw;
        }
        const int hqc = t0w & 0xff, hsel = (t0w >> 8) & 0xff;
        const int e1c = (t0w >> 16) & 0xff, e2c = t0w >> 24;
        const int kind = hqc >> 4;
        const bool emit_match = in_HQ && kind == 0;
        const bool emit_egap = in_E1 || in_E2;
        const bool src_done = local ? at_src : at_src && j == 0;
        const bool zero_done = local && in_HQ && kind == 3;
        if (emit_match || emit_egap) {
            if (lane == 0) emit(0, i, emit_match ? j - 1 : -1);
            ++op;
        }
        int nchan = chan;
        if (in_H) {
            nchan = hsel == 0 ? 1 : 4;
            if (hsel != 0) {
                // the F origin: the XLA function's key max over the
                // columns k < j of row r, (Hq + ext * k, k), ties to the
                // later column, a lane every 32nd column
                const int ext = hsel == 1 ? e : c;
                const int* qr = Qd + (long long)r * C;
                long long best = KEY_NONE;
#pragma unroll 4
                for (int k = j - 1 - lane; k >= 0; k -= 32)
                    best = lmax(best, key_of(qr[k] + ext * k, k));
                for (int o = 16; o; o >>= 1)
                    best = lmax(best, __shfl_xor_sync(FULL, best, o));
                ftgt = (int)((unsigned)best & 0xffffu);
            }
        }
        if (emit_match) nchan = 0;
        if (in_HQ && kind == 1) nchan = 2;
        if (in_HQ && kind == 2) nchan = 3;
        if (in_E1) nchan = (e1c >> 4) & 1 ? 0 : 2;
        if (in_E2) nchan = (e2c >> 4) & 1 ? 0 : 3;
        if (in_F) nchan = 1;          // here j <= ftgt: the origin
        int ni = i;
        if (emit_match) ni = pred_at(r, hqc & 15);
        if (in_E1) ni = pred_at(r, e1c & 15);
        if (in_E2) ni = pred_at(r, e2c & 15);
        if (emit_match) --j;
        i = ni;
        chan = nchan;
        ++it;
        done = src_done || zero_done;
    }
    if (lane == 0) {
        outpos[b] = op;
        bvout[b] = bv;
    }
}

// How a launch lays out: `threads` a block (a task a block), rows in one
// tile with the ring (`ring` = 1) or in tiles, the row tables in shared
// memory (`tables`), the dynamic shared bytes and the blocks an SM holds.
// Decided before the launch from the device's limits: with more tasks than
// SMs the tables stay in device memory unless two blocks an SM still fit.
struct BatchGeometry {
    int threads, ring, tables, smem, per_sm;
};

template <bool R, bool T>
cudaError_t configure(const BatchGeometry& g, int* per_sm) {
    const cudaError_t err = opt_in_smem(poa_batch_kernel<R, T>, g.smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, poa_batch_kernel<R, T>, g.threads, g.smem);
}

inline cudaError_t batch_geometry(int B, int Vp, int Lp, int P,
                                  BatchGeometry& g) {
    int dev = 0, smem_block = 0, smem_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    g.threads = block_threads(Lp);
    g.ring = Lp + 1 <= TILE_MAX && !(BATCH_CUTS & 4);
    // 1 KB an SM is reserved for each block
    long one = smem_sm - 1024;
    if (one > smem_block) one = smem_block;
    one -= STATIC_SMEM;
    const long two = smem_sm / 2 - 1024 - STATIC_SMEM;
    const long fixed = g.ring ? (long)ring_bytes(Lp) : 0;
    if (fixed > one) return cudaErrorInvalidValue;
    const long cap = B > sms && fixed <= two ? two : one;
    g.tables = Vp <= ID16_MAX && !(BATCH_CUTS & 8) &&
               fixed + (long)table_bytes(Vp, P) <= cap;
    g.smem = (int)(fixed + (g.tables ? (long)table_bytes(Vp, P) : 0));
#if BATCH_CUTS & 16
    if (g.smem < smem_sm / 2) g.smem = smem_sm / 2;  // one block an SM
#endif
    return g.ring ? (g.tables ? configure<true, true>(g, &g.per_sm)
                              : configure<true, false>(g, &g.per_sm))
                  : (g.tables ? configure<false, true>(g, &g.per_sm)
                              : configure<false, false>(g, &g.per_sm));
}

template <bool R, bool T>
cudaError_t launch_batch(const BatchGeometry& g, const int* base,
                         const int* pred, const int* seq, const int* slen,
                         const int* nvalid, const uint8_t* sink,
                         const int* par, int* out, int* outpos, int* bv,
                         int* scratch, int B, int V, int L, int P, int local,
                         cudaStream_t s) {
    poa_batch_kernel<R, T><<<B, g.threads, g.smem, s>>>(
        base, pred, seq, slen, nvalid, sink, par, out, outpos, bv, scratch,
        B, V, L, P, local);
    return cudaGetLastError();
}

}  // namespace

// int32 words of one task's device scratch: the planes H, E1, E2, T0 and
// Hq, each (Vp + 1) rows of Lp + 1 columns rounded up to 4, then the row
// tables for when they stay in device memory
extern "C" long long poa_batch_task_words(int Vp, int Lp) {
    return 5 * plane_words(Vp, Lp) + dtab_words(Vp);
}

// The launch geometry of B tasks at these sizes on the current device:
// out = (threads a block, one-tile rows with the ring, row tables in shared
// memory, dynamic shared bytes, blocks an SM).  Returns a CUDA error.
extern "C" int poa_batch_geometry(int B, int V, int L, int P, int* out) {
    if (V < 0 || L < 0 || L > MAXL || P < 1 || P > MAXP)
        return (int)cudaErrorInvalidValue;
    BatchGeometry g;
    const cudaError_t err = batch_geometry(B, V, L, P, g);
    if (err == cudaSuccess) {
        out[0] = g.threads; out[1] = g.ring; out[2] = g.tables;
        out[3] = g.smem; out[4] = g.per_sm;
    }
    return (int)err;
}

// Launch on `stream` (PyTorch's current stream), with `scratch` holding B
// tasks of poa_batch_task_words(V, L).  Returns cudaGetLastError() after
// the launch: nonzero means the launch was refused or an earlier
// asynchronous fault is pending, and the caller raises.
extern "C" int poa_batch_launch(const int* base, const int* pred,
                                const int* seq, const int* slen,
                                const int* nvalid, const uint8_t* sink,
                                const int* par, int* out, int* outpos,
                                int* bv, int* scratch, int B, int V, int L,
                                int P, int local, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (V < 0 || L < 0 || L > MAXL || P < 1 || P > MAXP)
        return cudaErrorInvalidValue;
    BatchGeometry g;
    const cudaError_t err = batch_geometry(B, V, L, P, g);
    if (err != cudaSuccess) return (int)err;
    auto fn = g.ring ? (g.tables ? launch_batch<true, true>
                                 : launch_batch<true, false>)
                     : (g.tables ? launch_batch<false, true>
                                 : launch_batch<false, false>);
    return (int)fn(g, base, pred, seq, slen, nvalid, sink, par, out, outpos,
                   bv, scratch, B, V, L, P, local,
                   static_cast<cudaStream_t>(stream));
}
