// poa_batch.cu — the batched per-round POA DP of `--engine jax`: for each
// task of a batch, one sequence against one POA graph, the DP fill in
// topological row order and a traceback through stored backpointers.
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
//   * the F prefix max takes the later column on ties: keys (value << 32 |
//     column) under a plain int64 max;
//   * the local best is the first row, then the first column, by strict >;
//     the global best the first row with the largest H at column slen
//     among sink rows (others count as NEG);
//   * the traceback is the lockstep state machine of five channels (H, Hq,
//     E1, E2, F), at most 2 * S steps.
//
// Design: one thread block of NT threads per task; a row is tiles of
// BTILE columns, BCPT consecutive columns a thread.  Every row's (H, E1,
// E2) and its packed backpointers stay in device memory (a predecessor can
// be any earlier row): an int4 {H, E1, E2, T0} per cell, T0 = hqbp | hsel
// << 8 | e1bp << 16 | e2bp << 24, and a word {fo1 | fo2 << 16} per cell, 20
// bytes.  The F channels are one block-wide exclusive max-scan of int64
// keys a tile (warp shuffles, then the warps' totals, one barrier on two
// alternating buffers), carried from tile to tile.  Thread 0 builds the
// next row's predecessor list once its own columns of the row are done,
// before the row's end barrier publishes it; each thread keeps
// the local best of its own cells, reduced once after the fill.  So a row
// of one tile costs two barriers: the scan's and the row's end, after
// which the next row may read it.  Thread 0 runs the traceback.  What
// bounds it on the card: the row chain (a row reads rows written by
// earlier ones, so rows of a task run one after another: two barriers and
// a dependent global load a row) and the traceback's dependent loads;
// tasks run side by side, one block each.  The int32 operations of the
// fill are the bound chip_smoke.py states.
#include "poa_common.cuh"

// Timing-only cuts (smoothxg_tpu_torch/tools/batch_cuts.py), 0 as built:
// bit 1 no traceback, bit 2 no block-wide F scan (each thread's own
// columns only).  A cut's outputs are invalid by design.
#ifndef BATCH_CUTS
#define BATCH_CUTS 0
#endif

namespace {

constexpr int BCPT = 4;                    // columns per thread per tile
constexpr int BTILE = NT * BCPT;           // columns per tile
constexpr int MAXP = 16;                   // predecessor slots (4-bit codes)
constexpr int MAXL = 65535;                // F origins are 16-bit columns
constexpr long long KEY_NONE = LLONG_MIN;  // an empty prefix

__device__ __forceinline__ long long lmax(long long a, long long b) {
    return a > b ? a : b;
}

// (value, column) as one int64 whose max is the max value, ties to the
// later column
__device__ __forceinline__ long long key_of(int v, int col) {
    return (long long)(((unsigned long long)(long long)v << 32) |
                       (unsigned)col);
}

// Block-wide exclusive prefix max, in thread order, of two int64 keys:
// ex* the max over the lower threads (KEY_NONE for thread 0), tot* over the
// whole block.  `sw` holds 2 * NWARP keys.  One barrier: the caller
// alternates between two such buffers, so a call never overwrites totals
// that a warp of the previous call may still read.
__device__ void block_excl_max2_64(long long t1, long long t2, long long& ex1,
                                   long long& ex2, long long& tot1,
                                   long long& tot2, long long* sw) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long i1 = t1, i2 = t2;
    for (int o = 1; o < 32; o <<= 1) {
        const long long y1 = __shfl_up_sync(FULL, i1, o);
        const long long y2 = __shfl_up_sync(FULL, i2, o);
        if (lane >= o) { i1 = lmax(i1, y1); i2 = lmax(i2, y2); }
    }
    ex1 = __shfl_up_sync(FULL, i1, 1);
    ex2 = __shfl_up_sync(FULL, i2, 1);
    if (lane == 0) { ex1 = KEY_NONE; ex2 = KEY_NONE; }
    if (lane == 31) { sw[warp] = i1; sw[NWARP + warp] = i2; }
    __syncthreads();
    tot1 = KEY_NONE; tot2 = KEY_NONE;
    for (int w = 0; w < NWARP; ++w) {
        if (w == warp) { ex1 = lmax(ex1, tot1); ex2 = lmax(ex2, tot2); }
        tot1 = lmax(tot1, sw[w]);
        tot2 = lmax(tot2, sw[NWARP + w]);
    }
}

// Thread 0: the distinct predecessor rows of row v in slot order, each with
// the slot of its first occurrence, and the row's base, into `s` (rows,
// slots, count, base)
__device__ __forceinline__ void pred_list(const int* pred, const int* base,
                                          int B, int b, int P, int v,
                                          int* s) {
    const int* pr = pred + ((long long)(v - 1) * B + b) * P;
    int np = 0;
    for (int k = 0; k < P; ++k) {
        const int r = pr[k];
        bool dup = false;
        for (int t = 0; t < np; ++t) dup |= s[t] == r;
        if (!dup) { s[np] = r; s[MAXP + np] = k; ++np; }
    }
    s[2 * MAXP] = np;
    s[2 * MAXP + 1] = base[(long long)(v - 1) * B + b];
}

template <bool LOCAL>
__global__ void __launch_bounds__(NT) poa_batch_kernel(
    const int* __restrict__ base, const int* __restrict__ pred,
    const int* __restrict__ seq, const int* __restrict__ slen,
    const int* __restrict__ nvalid, const uint8_t* __restrict__ sink,
    const int* __restrict__ par, int* __restrict__ out,
    int* __restrict__ outpos, int* __restrict__ bvout, int* scratch, int B,
    int Vp, int Lp, int P, int LS, long long task_words) {
    const int b = blockIdx.x, tid = threadIdx.x;
    const int V = min(max(nvalid[b], 0), Vp);
    const int L = min(max(slen[b], 0), Lp);
    const int* pb = par + 6LL * b;
    const int m = pb[0], n = pb[1], g = pb[2], e = pb[3], q = pb[4],
              c = pb[5];
    int4* HE = reinterpret_cast<int4*>(scratch + (long long)b * task_words);
    unsigned* T1 = reinterpret_cast<unsigned*>(
        scratch + (long long)b * task_words + 4LL * (Vp + 1) * LS);
    const int* sq = seq + (long long)b * Lp;
    const int S = Vp + Lp + 5;
    int* ob = out + 2LL * S * b;

    // two predecessor lists (rows, slots, count, base), the next row's
    // built while the current one is filled; two F scan buffers
    __shared__ int s_pl[2][2 * MAXP + 2];
    __shared__ long long s_scan[2][2 * NWARP];
    __shared__ int s_rv[NWARP], s_rr[NWARP];
    __shared__ long long s_ri[NWARP];

    for (int k = tid; k < 2 * S; k += NT) ob[k] = -9;
    // row 0, the virtual source: H is 0 (local) or the leading-gap row
    for (int col = tid; col <= L; col += NT) {
        int h = 0;
        if (!LOCAL && col > 0)
            h = max(-(g + (col - 1) * e), -(q + (col - 1) * c));
        HE[col] = make_int4(h, NEG, NEG, 0);
    }
    // the local best of this thread's cells: the largest H, the first row
    // and then the first column among equal ones (the XLA function's row
    // scan with a strict >, reduced over the block once, after the fill)
    int tv = INT_MIN;
    long long tcell = LLONG_MAX;
    if (tid == 0 && V > 0) pred_list(pred, base, B, b, P, 1, s_pl[1]);
    int scans = 0;
    __syncthreads();

    for (int v = 1; v <= V; ++v) {
        const int* pl = s_pl[v & 1];
        const int* s_row = pl;
        const int* s_slot = pl + MAXP;
        const int np = pl[2 * MAXP], bnode = pl[2 * MAXP + 1];
        int4* row = HE + (long long)v * LS;
        unsigned* row1 = T1 + (long long)v * LS;
        long long carry1 = KEY_NONE, carry2 = KEY_NONE;
        for (int t0 = 0; t0 <= L; t0 += BTILE) {
            const int c0 = t0 + tid * BCPT;
            // predecessor maxima: H at columns c0 - 1 .. c0 + BCPT - 1
            // (index k is column c0 - 1 + k), E1 and E2 at c0 .. c0 + BCPT
            // - 1 (index k - 1).  All of a predecessor's loads are issued
            // before any is used, so a row waits for one read of each
            // predecessor, not one a column.
            int hm[BCPT + 1], ha[BCPT + 1], x1m[BCPT], x1a[BCPT], x2m[BCPT],
                x2a[BCPT];
#pragma unroll
            for (int k = 0; k <= BCPT; ++k) {
                hm[k] = INT_MIN; ha[k] = 0;
                if (k) { x1m[k - 1] = INT_MIN; x1a[k - 1] = 0;
                         x2m[k - 1] = INT_MIN; x2a[k - 1] = 0; }
            }
            for (int t = 0; t < np; ++t) {
                const int4* pr = HE + (long long)s_row[t] * LS;
                const int sl = s_slot[t];
                int4 x[BCPT + 1];
#pragma unroll
                for (int k = 0; k <= BCPT; ++k) {
                    const int col = c0 - 1 + k;
                    x[k] = col >= 0 && col <= L
                               ? pr[col] : make_int4(INT_MIN, INT_MIN,
                                                     INT_MIN, 0);
                }
#pragma unroll
                for (int k = 0; k <= BCPT; ++k) {
                    if (x[k].x > hm[k]) { hm[k] = x[k].x; ha[k] = sl; }
                    if (k && x[k].y > x1m[k - 1]) {
                        x1m[k - 1] = x[k].y; x1a[k - 1] = sl;
                    }
                    if (k && x[k].z > x2m[k - 1]) {
                        x2m[k - 1] = x[k].z; x2a[k - 1] = sl;
                    }
                }
            }
            int hq[BCPT], e1[BCPT], e2[BCPT];
            unsigned w0[BCPT];
            long long k1[BCPT], k2[BCPT], tot1 = KEY_NONE, tot2 = KEY_NONE;
#pragma unroll
            for (int k = 0; k < BCPT; ++k) {
                const int col = c0 + k;
                k1[k] = KEY_NONE; k2[k] = KEY_NONE;
                hq[k] = NEG; e1[k] = NEG; e2[k] = NEG; w0[k] = 0;
                if (col > L) continue;
                int M = NEG, mp = 0;
                if (col > 0) {
                    M = hm[k] + (sq[col - 1] == bnode ? m : -n);
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
                if (LOCAL) {
                    hv = max(hv, 0);
                    kind = hv == 0 ? 3 : M == hv ? 0 : e1[k] == hv ? 1 : 2;
                } else {
                    kind = M == hv ? 0 : e1[k] == hv ? 1 : 2;
                }
                const int kp = kind == 0 ? mp
                             : kind == 1 ? (e1bp & 15) : (e2bp & 15);
                hq[k] = hv;
                w0[k] = (unsigned)((kind << 4) | kp) | ((unsigned)e1bp << 16) |
                        ((unsigned)e2bp << 24);
                k1[k] = key_of(hv + e * col, col);
                k2[k] = key_of(hv + c * col, col);
                tot1 = lmax(tot1, k1[k]);
                tot2 = lmax(tot2, k2[k]);
            }
            long long ex1, ex2, bt1, bt2;
            if (BATCH_CUTS & 2) {
                ex1 = ex2 = KEY_NONE; bt1 = tot1; bt2 = tot2;
            } else {
                block_excl_max2_64(tot1, tot2, ex1, ex2, bt1, bt2,
                                   s_scan[scans++ & 1]);
            }
            ex1 = lmax(ex1, carry1);
            ex2 = lmax(ex2, carry2);
            carry1 = lmax(carry1, bt1);
            carry2 = lmax(carry2, bt2);
#pragma unroll
            for (int k = 0; k < BCPT; ++k) {
                const int col = c0 + k;
                if (col > L) continue;
                int F1 = NEG, F2 = NEG;
                unsigned fo1 = 0, fo2 = 0;
                if (ex1 != KEY_NONE) {
                    F1 = (int)(ex1 >> 32) - g - e * (col - 1);
                    fo1 = (unsigned)ex1 & 0xffffu;
                }
                if (ex2 != KEY_NONE) {
                    F2 = (int)(ex2 >> 32) - q - c * (col - 1);
                    fo2 = (unsigned)ex2 & 0xffffu;
                }
                ex1 = lmax(ex1, k1[k]);
                ex2 = lmax(ex2, k2[k]);
                const int H = max(hq[k], max(F1, F2));
                const unsigned hsel = H == hq[k] ? 0u : H == F1 ? 1u : 2u;
                row[col] = make_int4(H, e1[k], e2[k], (int)(w0[k] | hsel << 8));
                row1[col] = fo1 | fo2 << 16;
                if (LOCAL && H > tv) {
                    tv = H;
                    tcell = (long long)v * LS + col;
                }
            }
        }
        if (tid == 0 && v < V)
            pred_list(pred, base, B, b, P, v + 1, s_pl[(v + 1) & 1]);
        __syncthreads();             // row v is read by the rows after it
    }

    int bv = NEG, bi = 0, bj = 0;
    if (LOCAL) {
        // max value, ties to the smaller cell index (row, then column)
        for (int o = 16; o; o >>= 1) {
            const int ov = __shfl_down_sync(FULL, tv, o);
            const long long oc = __shfl_down_sync(FULL, tcell, o);
            if (ov > tv || (ov == tv && oc < tcell)) { tv = ov; tcell = oc; }
        }
        if ((tid & 31) == 0) { s_rv[tid >> 5] = tv; s_ri[tid >> 5] = tcell; }
        __syncthreads();
        tv = s_rv[0]; tcell = s_ri[0];
        for (int w = 1; w < NWARP; ++w)
            if (s_rv[w] > tv || (s_rv[w] == tv && s_ri[w] < tcell)) {
                tv = s_rv[w]; tcell = s_ri[w];
            }
        if (tv > NEG) { bv = tv; bi = (int)(tcell / LS); bj = (int)(tcell % LS); }
    }

    if (!LOCAL) {
        // the first row with the largest H at column L; rows that are no
        // sink count as NEG, so with no sink it is row 0
        int hv = INT_MIN, hr = INT_MAX;
        for (int r = tid; r <= V; r += NT) {
            const int x = sink[(long long)b * (Vp + 1) + r]
                              ? HE[(long long)r * LS + L].x : NEG;
            if (x > hv || (x == hv && r < hr)) { hv = x; hr = r; }
        }
        reduce_best(hv, hr, s_rv, s_rr);
        bv = hv; bi = hr; bj = L;
    }
    if (tid != 0) return;
    if (BATCH_CUTS & 1) { outpos[b] = 0; bvout[b] = bv; return; }

    // traceback: the XLA function's state machine, one step an iteration
    // (channels 0 = H, 1 = Hq, 2 = E1, 3 = E2, 4 = F)
    int i = bi, j = bj, chan = 0, ftgt = 0, op = 0;
    bool done = LOCAL ? bv <= 0 : false;
    for (int it = 0; !done && it < 2 * S; ++it) {
        const bool i0 = i == 0;
        const bool in_H = chan == 0 && !i0, in_HQ = chan == 1 && !i0;
        const bool in_E1 = chan == 2, in_E2 = chan == 3, in_F = chan == 4;
        const bool at_src = chan <= 1 && i0;
        // the tables of row max(i, 1) (the XLA function reads row index
        // max(i - 1, 0) of its tables, which start at row 1)
        unsigned t0w = 0, t1w = 0;
        const int r = max(i, 1);
        const int* prs = pred + ((long long)(r - 1) * B + b) * P;
        if ((in_H || in_HQ || in_E1 || in_E2) && r <= V) {
            t0w = (unsigned)HE[(long long)r * LS + j].w;
            t1w = T1[(long long)r * LS + j];
        }
        const int hqc = t0w & 0xff, hsel = (t0w >> 8) & 0xff;
        const int e1c = (t0w >> 16) & 0xff, e2c = t0w >> 24;
        const int kind = hqc >> 4;
        const bool emit_match = in_HQ && kind == 0;
        const bool emit_egap = in_E1 || in_E2;
        const bool f_step = in_F && j > ftgt;
        const bool src_ins = !LOCAL && at_src && j > 0;
        const bool src_done = LOCAL ? at_src : at_src && j == 0;
        const bool zero_done = LOCAL && in_HQ && kind == 3;
        const bool emit_ins = f_step || src_ins;
        if (emit_match || emit_egap || emit_ins) {
            if (op < S) {
                ob[2 * op] = emit_match || emit_egap ? i : -1;
                ob[2 * op + 1] = emit_match || emit_ins ? j - 1 : -1;
            }
            ++op;
        }
        int nchan = chan;
        if (in_H) {
            nchan = hsel == 0 ? 1 : 4;
            if (hsel == 1) ftgt = (int)(t1w & 0xffffu);
            else if (hsel == 2) ftgt = (int)(t1w >> 16);
        }
        if (emit_match) nchan = 0;
        if (in_HQ && kind == 1) nchan = 2;
        if (in_HQ && kind == 2) nchan = 3;
        if (in_E1) nchan = (e1c >> 4) & 1 ? 0 : 2;
        if (in_E2) nchan = (e2c >> 4) & 1 ? 0 : 3;
        if (in_F && !f_step) nchan = 1;
        if (src_ins) nchan = 0;
        int ni = i;
        if (emit_match) ni = prs[hqc & 15];
        if (in_E1) ni = prs[e1c & 15];
        if (in_E2) ni = prs[e2c & 15];
        if (emit_match || emit_ins) --j;
        i = ni;
        chan = nchan;
        done = src_done || zero_done;
    }
    outpos[b] = op;
    bvout[b] = bv;
}

}  // namespace

// int32 words of one task's device scratch: (Vp + 1) rows of LS = Lp + 1
// rounded up to 4 columns, an int4 and a word a cell
extern "C" long long poa_batch_task_words(int Vp, int Lp) {
    const long long LS = (Lp + 4) & ~3;
    return 5LL * (Vp + 1) * LS;
}

extern "C" int poa_batch_launch(const int* base, const int* pred,
                                const int* seq, const int* slen,
                                const int* nvalid, const uint8_t* sink,
                                const int* par, int* out, int* outpos,
                                int* bv, int* scratch, int B, int V, int L,
                                int P, int local, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (V < 0 || L < 0 || L > MAXL || P < 1 || P > MAXP)
        return cudaErrorInvalidValue;
    const int LS = (L + 4) & ~3;
    const long long words = poa_batch_task_words(V, L);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (local)
        poa_batch_kernel<true><<<B, NT, 0, s>>>(
            base, pred, seq, slen, nvalid, sink, par, out, outpos, bv,
            scratch, B, V, L, P, LS, words);
    else
        poa_batch_kernel<false><<<B, NT, 0, s>>>(
            base, pred, seq, slen, nvalid, sink, par, out, outpos, bv,
            scratch, B, V, L, P, LS, words);
    return cudaGetLastError();
}
