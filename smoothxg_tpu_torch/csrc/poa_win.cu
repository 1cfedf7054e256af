// poa_win.cu — whole-block partial order alignment on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smoothxg_tpu/ops/poa_pallas_win.py:_win_core
// (wrapper _win_fn).  One thread block runs one POA block's entire loop:
// seed a chain from sequence 0, then for each later sequence fill the
// sequence-vs-DAG DP in topological order, trace it back and thread the
// sequence into the graph.  The semantics are those of the numpy oracle
// smoothxg_tpu/ops/poa_fused.FusedPOA (+ ops/poa_host), bit for bit, and
// of the plain PyTorch version smoothxg_tpu_torch/ops/poa_win.py:
// poa_win_reference, which is written line for line against this file.
//
// What bounds it on this card: latency, not bytes or operations.  The
// algorithm has one parallel axis — the columns of a DP row — wrapped in
// scalar graph work: per row, the predecessor rows' round trip to L2, a
// block-wide prefix max for the F channels and the barriers around it; per
// round, the topological walk, the banded rank pass, the traceback and the
// threading, chains of dependent table reads.
// What the design does about it (that of poa_code.cu, with value planes
// and stored windows):
//   * the graph tables are poa_graph.cuh's compact `Tables` (int16 ids and
//     rows, int8 bases and counts), in shared memory when they fit beside
//     the launch's blocks per SM (`win_geometry`), else in device scratch;
//     the kernel is a template on that placement;
//   * full-width rows are stored at the launch's row stride LS (the batch's
//     longest sequence + 1, rounded up to 32 columns) instead of the caps'
//     W, so a launch's scratch follows its sequences; a banded launch keeps
//     rows of W columns from the row's band floor (the window covers the
//     whole band), rounded up to 8 for 16-byte stores;
//   * each thread owns 8 consecutive columns: predecessor rows of a
//     full-width row are read as two int4 loads a plane (a banded row's
//     window starts at its own offset, so it reads scalars), and every
//     store is two int4;
//   * the next row's metadata (count, base, band, predecessor rows packed
//     as int16 pairs) is issued before this row's scan;
//   * at most 128 registers with no local arrays, so two blocks share an
//     SM and cover each other's barriers;
//   * the traceback runs in warp 0: every lane follows the same path; on
//     full-width rows a run of up to 32 M moves along rows whose only
//     predecessor is the row above is read ahead, one step a lane, and
//     taken up to its first other step; any other step's plane reads (E1,
//     E2 and the predecessors' H, one predecessor a lane) are issued
//     together and the first match is a ballot, and the F origin is
//     searched 32 columns at a time with a ballot for the nearest; the
//     local end cell's column likewise.
// The F channels use the closed form F(j) = max_{k<j}(hq(k) + ext*k) -
// open - ext*(j-1) as a warp-shuffle scan plus a scan of per-warp totals,
// double-buffered so a tile needs one barrier; the row-end barrier stays
// (the next row reads this row's H at each thread's left neighbour).
// Scores are int32 with the floor NEG = -2^30 (no int16 clamp), and the DP
// planes (H, Hq, E1, E2: 16 bytes per cell) live in device memory.
// A stored row past one tile (2,048 columns: the CLI's default -l 4000,
// the (6144, 3072) tier, the windowed tier's 3,072-column window) takes
// the cluster route instead (poa_win_cluster_kernel below): one thread
// block a tile of the row, on as many SMs, so a row costs one tile's fill
// and a hand-off, not a tile after another on one SM.  The route is chosen
// from the launch's shape (`cluster_size`); a cluster the card cannot hold
// fails the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
//        -fPIC, one process per source, then one link into a shared
//        library (smoothxg_tpu_torch/ops/_build.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "poa_common.cuh"
#include "poa_graph.cuh"
#include "smem.cuh"

namespace {

constexpr int PCAP_MAX = 8;
constexpr int STATIC_SMEM = 1024;    // above the kernel's static buffers

// stored columns of a DP row: the launch's row stride, or a banded
// launch's window rounded up to 8
__host__ __device__ inline int row_stride(int W, int LS, int banded) {
    return banded ? (W + 7) & ~7 : LS;
}

// device scratch of one POA block: the graph tables (used when they stay
// in device memory), then the int32 planes H Hq E1 E2, each (VW + 1) x
// row_stride — mirrored by WinCaps.scratch_words in ops/poa_win.py
__host__ __device__ inline size_t block_bytes(size_t v1, int pcap, int W,
                                              int LS, int banded) {
    return table_bytes(v1, pcap, LS, banded)
         + 16 * v1 * (size_t)row_stride(W, LS, banded);
}

// a row's metadata: predecessor count, node base, band, and the
// predecessor rows, two int16 a word (slots past the count are stale)
struct RowMeta {
    int np, bv, blo, bhi;
    int pr[PCAP_MAX / 2];
};

__device__ __forceinline__ RowMeta row_meta(const Tables& k, int i, int L,
                                            int pcap, int banded) {
    RowMeta r;
    r.np = k.rnp[i];
    r.bv = k.rbase[i];
    r.blo = banded ? k.rlo[i] : 0;
    r.bhi = banded ? k.rhi[i] : L;
    const int16_t* rp = k.rpreds + (size_t)i * pcap;
#pragma unroll
    for (int p = 0; p < PCAP_MAX; p += 2) {
        const int lo = p < pcap ? (uint16_t)rp[p] : 0;
        const int hi = p + 1 < pcap ? (uint16_t)rp[p + 1] : 0;
        r.pr[p / 2] = lo | (hi << 16);
    }
    return r;
}

// predecessor row of slot p (row 0, the virtual source, without any); the
// word is selected, not indexed, so a slot that is not a constant keeps
// the metadata in registers
__device__ __forceinline__ int meta_row(const RowMeta& r, int p) {
    const int w = p < 2 ? r.pr[0] : p < 4 ? r.pr[1] : p < 6 ? r.pr[2]
                                                    : r.pr[3];
    return r.np > 0 ? (w >> (16 * (p & 1))) & 0xFFFF : 0;
}

__device__ __forceinline__ int part(const int4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// the block's capacity check (every thread computes the same verdict; LS
// is above every length that fits LW, see poa_win_launch): the seed's
// length, or -1 when the block overflows
__device__ __forceinline__ int capacity(const int32_t* lens, int R, int RW,
                                        int LW, int VW, int W, int LS,
                                        int banded) {
    if (R < 1 || R > RW) return -1;
    const int L0 = lens[0];
    int maxL = 0;
    for (int r = 0; r < R; ++r) maxL = max(maxL, lens[r]);
    const bool ovf = L0 < 1 || L0 > VW || maxL > LW - 1 || maxL > LS - 1
                  || (!banded && maxL + 1 > W);
    return ovf ? -1 : L0;
}

// row 0, the virtual source, in the planes H Hq E1 E2
__device__ __forceinline__ void row_zero(int32_t* H, size_t plane, int RS,
                                         int local, int g, int e, int q,
                                         int c, int first, int stride) {
    for (int jl = first; jl < RS; jl += stride) {
        int32_t h, hq;
        if (local) { h = 0; hq = 0; }
        else if (jl == 0) { h = 0; hq = 0; }
        else {
            h = max(-(g + (jl - 1) * e), -(q + (jl - 1) * c));
            hq = NEG;
        }
        H[jl] = h; H[plane + jl] = hq;
        H[2 * plane + jl] = NEG; H[3 * plane + jl] = NEG;
    }
}

// a global alignment's end row: the sink row of the best H at column L,
// ties to the lower row (every thread of the block takes part)
template <class RD>
__device__ __forceinline__ int sink_row(const Tables& k, RD rd,
                                        const int32_t* H, int V, int L,
                                        int* sv, int* sr) {
    int hb = NEG - 1, hr = 0;
    for (int i = 1 + (int)threadIdx.x; i <= V; i += NT) {
        if (k.nsucc[k.rnode[i]] != 0) continue;
        const int h = rd(H, i, L);
        if (h > hb) { hb = h; hr = i; }
    }
    if (hr == 0) hr = INT_MAX;           // no sink in this thread
    reduce_best(hb, hr, sv, sr);
    return hr == INT_MAX ? 0 : hr;       // (a DAG always has a sink)
}

// the block's outputs: its graph (node rows from `first` by `stride`,
// the order and meta by the `lead` thread), or an overflowed block's
// canonical ones
__device__ __forceinline__ void export_block(const Tables& k,
                                             int32_t* bpaths, size_t npaths,
                                             int32_t* bexp, int32_t* bmeta,
                                             int VW, int R, int ovf, int Vc,
                                             int head, int gs, int first,
                                             int stride, bool lead) {
    if (ovf) {
        export_overflow_par(bpaths, npaths, bexp, VW, first, stride);
        if (lead) {
            bmeta[0] = 0; bmeta[1] = 1; bmeta[2] = R; bmeta[3] = 0;
        }
        return;
    }
    export_nodes_par(k, bexp, VW, Vc, first, stride);
    if (lead) {
        export_order(k, bexp, VW, Vc, head);
        bmeta[0] = Vc; bmeta[1] = 0; bmeta[2] = R; bmeta[3] = gs;
    }
}

// One thread's CPT columns from jb of a DP row, first half: the
// predecessor maxima of H at jb-1 .. jb+CPT-1 and of E1, E2 at jb ..
// jb+CPT-1, then hq, e1 and e2 (stored from the stored column jl0) and the
// thread's totals t1, t2 of the F channels' prefix max.  BANDED: a window
// from each predecessor's band floor, read as scalars; else full-width
// predecessor rows read as int4s.
template <bool BANDED>
__device__ __forceinline__ void fill_hq(const Tables& k, const int32_t* H,
                                        size_t plane, int RS, int W,
                                        const RowMeta& cur, int npr, int jb,
                                        int jl0, int c0, int c1, int bhi,
                                        const int8_t* s_seq, int m, int n,
                                        int g, int e, int q, int c,
                                        int local, int32_t* Hqi,
                                        int32_t* E1i, int32_t* E2i,
                                        int (&hq)[CPT], int& t1, int& t2) {
    int hp[CPT + 1], x1[CPT], x2[CPT];
#pragma unroll
    for (int x = 0; x <= CPT; ++x) hp[x] = NEG;
#pragma unroll
    for (int x = 0; x < CPT; ++x) { x1[x] = NEG; x2[x] = NEG; }
    if constexpr (!BANDED) {
#pragma unroll
        for (int p = 0; p < PCAP_MAX; ++p) {
            if (p >= npr) break;
            // full width: columns jb .. jb+7 as int4s
            const int32_t* rb = H + (size_t)meta_row(cur, p) * RS + jb;
            const int4 a0 = ((const int4*)rb)[0];
            const int4 a1 = ((const int4*)rb)[1];
            const int4 b0 = ((const int4*)(rb + 2 * plane))[0];
            const int4 b1 = ((const int4*)(rb + 2 * plane))[1];
            const int4 d0 = ((const int4*)(rb + 3 * plane))[0];
            const int4 d1 = ((const int4*)(rb + 3 * plane))[1];
            hp[0] = max(hp[0], jb > 0 ? rb[-1] : NEG);
#pragma unroll
            for (int x = 0; x < CPT; ++x) {
                hp[x + 1] = max(hp[x + 1], part(x < 4 ? a0 : a1, x & 3));
                x1[x] = max(x1[x], part(x < 4 ? b0 : b1, x & 3));
                x2[x] = max(x2[x], part(x < 4 ? d0 : d1, x & 3));
            }
        }
    } else {
        // one predecessor at a time (the scalar window reads need the
        // registers an unrolled loop would take)
#pragma unroll 1
        for (int p = 0; p < npr; ++p) {
            const int pr = meta_row(cur, p);
            const int poff = k.rlo[pr];
            const int32_t* rb = H + (size_t)pr * RS;
#pragma unroll
            for (int x = 0; x <= CPT; ++x) {
                const int jl = jb - 1 + x - poff;
                if (jb - 1 + x <= c1 && jl >= 0 && jl < W)
                    hp[x] = max(hp[x], rb[jl]);
            }
#pragma unroll
            for (int x = 0; x < CPT; ++x) {
                const int jl = jb + x - poff;
                if (jb + x <= c1 && jl >= 0 && jl < W) {
                    x1[x] = max(x1[x], rb[2 * plane + jl]);
                    x2[x] = max(x2[x], rb[3 * plane + jl]);
                }
            }
        }
    }
#pragma unroll
    for (int x = 0; x < CPT; ++x) {
        const int j = jb + x;
        int h = NEG, e1 = NEG, e2 = NEG;
        if (j <= c1) {
            const int M = j == 0 ? NEG
                : hp[x] + ((int)s_seq[j - 1] == cur.bv ? m : -n);
            e1 = max(max(hp[x + 1] - g, x1[x] - e), NEG);
            e2 = max(max(hp[x + 1] - q, x2[x] - c), NEG);
            h = max(M, max(e1, e2));
            if (local) h = max(h, 0);
            if (j < c0 || j > bhi) { h = NEG; e1 = NEG; e2 = NEG; }
            t1 = max(t1, h + e * j);
            t2 = max(t2, h + c * j);
        }
        hq[x] = h;
        x1[x] = e1;
        x2[x] = e2;
    }
    ((int4*)(Hqi + jl0))[0] = make_int4(hq[0], hq[1], hq[2], hq[3]);
    ((int4*)(Hqi + jl0))[1] = make_int4(hq[4], hq[5], hq[6], hq[7]);
    ((int4*)(E1i + jl0))[0] = make_int4(x1[0], x1[1], x1[2], x1[3]);
    ((int4*)(E1i + jl0))[1] = make_int4(x1[4], x1[5], x1[6], x1[7]);
    ((int4*)(E2i + jl0))[0] = make_int4(x2[0], x2[1], x2[2], x2[3]);
    ((int4*)(E2i + jl0))[1] = make_int4(x2[4], x2[5], x2[6], x2[7]);
}

// Second half: H = max(hq, F1, F2) at the thread's columns from the
// exclusive prefix maxima g1, g2 (the carry of the columns to the left
// included), stored from jl0; the row's best in the band into rowbest.
__device__ __forceinline__ void fill_h(const int (&hq)[CPT], int jb, int jl0,
                                       int c1, int bhi, int g1, int g2, int g,
                                       int e, int q, int c, int& rowbest,
                                       int32_t* Hi) {
    int hv[CPT];
#pragma unroll
    for (int x = 0; x < CPT; ++x) {
        const int j = jb + x;
        int h = NEG;
        if (j <= c1) {
            h = hq[x];
            if (j > 0) {
                const int f1 = g1 - g - e * (j - 1);
                const int f2 = g2 - q - c * (j - 1);
                h = max(h, max(f1, f2));
            }
            g1 = max(g1, hq[x] + e * j);
            g2 = max(g2, hq[x] + c * j);
            if (j > bhi) h = NEG;     // (j >= c0 = band floor)
            else rowbest = max(rowbest, h);
        }
        hv[x] = h;
    }
    ((int4*)(Hi + jl0))[0] = make_int4(hv[0], hv[1], hv[2], hv[3]);
    ((int4*)(Hi + jl0))[1] = make_int4(hv[4], hv[5], hv[6], hv[7]);
}

// Traceback by value re-derivation from the end cell (ei, ej) in warp 0:
// every lane follows the same path; lane 0 writes the match targets.  A
// local end cell's column is the first stored one of row ei that holds
// tbest.  `rd(plane, row, j)` reads column j of a DP row.  Returns true
// when the trace gets stuck (cannot happen with a correct fill).
template <bool BANDED, class RD>
__device__ __forceinline__ bool trace_warp(Tables& k, RD rd,
                                           const int32_t* H,
                                           const int32_t* Hq,
                                           const int32_t* E1,
                                           const int32_t* E2,
                                           const int8_t* s_seq, int RS,
                                           int ei, int ej, int tbest,
                                           int local, int m, int n, int g,
                                           int e, int q, int c, int lane) {
    if (local) {                      // first stored column = best
        const int32_t* row = H + (size_t)ei * RS;
        for (int q0 = 0; q0 < RS; q0 += 32) {
            const int jl = q0 + lane;
            const unsigned hit =
                __ballot_sync(FULL, jl < RS && row[jl] == tbest);
            if (hit) { ej = q0 + __ffs(hit) - 1; break; }
        }
        ej += BANDED ? k.rlo[ei] : 0;
    }
    int i = ei, j = ej, chan = 0;     // 0 H, 1 Hq, 2 E1, 3 E2
    int val = rd(H, i, j);
    while (true) {
        if (chan <= 1) {
            if (local && val == 0) break;
            if (i == 0) {
                if (j == 0) break;
                if (lane == 0) k.target[j - 1] = -1;  // leading insertion
                --j;
                val = rd(H, 0, j);
                chan = 0;
                continue;
            }
            if (!BANDED && j > 0) {
                // a run of M steps read ahead, one a lane: lane t takes
                // the step from (i - t, j - t) when that row's only
                // predecessor is the row above, so 32 steps cost one
                // round trip; the run ends at the first step that is not
                // such an M move
                const int r = i - lane, cl = j - lane;
                const bool ok = r >= 1 && cl >= 1 && k.rnp[r] <= 1
                             && pred_row(k, r, 0) == r - 1;
                if (__ballot_sync(FULL, ok) & 1) {
                    int h = 0, sv = 0, vn = 0;
                    if (ok) {
                        vn = k.rnode[r];
                        h = rd(H, r - 1, cl - 1);
                        sv = (int)s_seq[cl - 1] == k.base[vn] ? m : -n;
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
                    const int run = __ffs(~go) ? __ffs(~go) - 1 : 32;
                    if (run > 0) {
                        if (lane < run) k.target[cl - 1] = vn;
                        val = __shfl_sync(FULL, vt - sv, run - 1);
                        i -= run; j -= run; chan = 0;
                        continue;
                    }
                }
            }
            const int v = k.rnode[i];
            const int np = k.rnp[i], npr = np > 0 ? np : 1;
            const int e1v = rd(E1, i, j), e2v = rd(E2, i, j);
            if (j > 0) {
                const int subv = (int)s_seq[j - 1] == k.base[v] ? m : -n;
                int hit = 0, pr = 0;
                if (lane < npr) {
                    pr = pred_row(k, i, lane);
                    hit = rd(H, pr, j - 1) + subv == val;
                }
                const unsigned hm = __ballot_sync(FULL, hit);
                if (hm) {                 // H there is val - subv
                    if (lane == 0) k.target[j - 1] = v;
                    i = __shfl_sync(FULL, pr, __ffs(hm) - 1);
                    --j; chan = 0;
                    val -= subv;
                    continue;
                }
            }
            if (e1v == val) { chan = 2; continue; }
            if (e2v == val) { chan = 3; continue; }
            if (chan == 0) {
                // nearest origin kk < j, 32 columns a step
                int kf = -1, hf = 0;
                for (int k0 = j - 1; k0 >= 0 && kf < 0; k0 -= 32) {
                    const int kk = k0 - lane;
                    int hit = 0, h = 0;
                    if (kk >= 0) {
                        h = rd(Hq, i, kk);
                        hit = h - g - (j - 1 - kk) * e == val ||
                              h - q - (j - 1 - kk) * c == val;
                    }
                    const unsigned hm = __ballot_sync(FULL, hit);
                    if (hm) {
                        kf = k0 - (__ffs(hm) - 1);
                        hf = __shfl_sync(FULL, h, __ffs(hm) - 1);
                    }
                }
                if (kf >= 0) {
                    for (int t = kf + lane; t < j; t += 32)
                        k.target[t] = -1;
                    j = kf; chan = 1;
                    val = hf;             // Hq at the origin
                    continue;
                }
            }
            return true;                  // stuck: cannot happen
        }
        const int op = chan == 2 ? g : q, ex = chan == 2 ? e : c;
        const int32_t* Em = chan == 2 ? E1 : E2;
        const int np = k.rnp[i], npr = np > 0 ? np : 1;
        int hh = 0, he = 0, pr = 0, hv = 0, ev = 0;
        if (lane < npr) {
            pr = pred_row(k, i, lane);
            hv = rd(H, pr, j);
            ev = rd(Em, pr, j);
            hh = hv - op == val;
            he = ev - ex == val;
        }
        const unsigned mh = __ballot_sync(FULL, hh);
        const unsigned me = __ballot_sync(FULL, he);
        if (mh) {
            const int s = __ffs(mh) - 1;
            i = __shfl_sync(FULL, pr, s);
            val = __shfl_sync(FULL, hv, s);
            chan = 0;
        } else if (me) {
            const int s = __ffs(me) - 1;
            i = __shfl_sync(FULL, pr, s);
            val = __shfl_sync(FULL, ev, s);
        } else {
            return true;                  // broken E chain
        }
    }
    return false;
}

// BANDED: rows in windows from their band floors, predecessor windows
// read as scalars; else full-width rows read as int4s
template <bool SMEM_TABLES, bool BANDED>
__global__ void __launch_bounds__(NT, 2)
poa_win_kernel(const int8_t* __restrict__ seqs, const int32_t* __restrict__ slen,
               const int32_t* __restrict__ nseq, const int32_t* __restrict__ params,
               int32_t* meta, int32_t* exp_, int32_t* paths, int8_t* scratch,
               int RW, int LW, int VW, int W, int pcap, int LS, int local) {
    constexpr int banded = BANDED;
    // dynamic: the tables (when in shared memory), then the round's
    // sequence (LS bytes)
    extern __shared__ int4 s_dyn[];
    __shared__ int s_w1[2][NWARP], s_w2[2][NWARP];
    __shared__ int s_rv[NWARP], s_rr[NWARP];
    __shared__ int s_ovf, s_V, s_Vc, s_head, s_gs, s_D;

    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31;
    const size_t v1 = (size_t)VW + 1;
    const int RS = row_stride(W, LS, banded);
    const size_t tb = table_bytes(v1, pcap, LS, banded);
    const size_t plane = v1 * (size_t)RS;
    int8_t* sm = (int8_t*)s_dyn;
    int8_t* sc = scratch + (size_t)b * block_bytes(v1, pcap, W, LS, banded);
    Tables k;
    graph_carve(k, SMEM_TABLES ? sm : sc, v1, pcap, LS, banded);
    int8_t* s_seq = sm + (SMEM_TABLES ? tb : 0);
    int32_t* H = (int32_t*)(sc + tb);
    int32_t* Hq = H + plane;
    int32_t* E1 = Hq + plane;
    int32_t* E2 = E1 + plane;

    const int R = nseq[b];
    const int32_t* lens = slen + (size_t)b * RW;
    const int32_t* pp = params + (size_t)b * 8;
    const int m = pp[0], n = pp[1], g = pp[2], e = pp[3], q = pp[4],
              c = pp[5];
    const int8_t* bseqs = seqs + (size_t)b * RW * LW;
    int32_t* bpaths = paths + (size_t)b * RW * LW;

    // column j of DP row `row`; cells outside the stored window are the
    // floor by banded semantics (the window covers the whole band)
    auto rd = [&](const int32_t* pl, int row, int j) -> int32_t {
        const int jl = j - (banded ? (int)k.rlo[row] : 0);
        return (jl >= 0 && jl < W) ? pl[(size_t)row * RS + jl] : NEG;
    };

    for (size_t x = tid; x < (size_t)RW * LW; x += NT) bpaths[x] = -1;
    __syncthreads();

    // ---- capacity check (every thread computes the same verdict; LS is
    // above every length that fits LW, see poa_win_launch) ----
    const int L0 = capacity(lens, R, RW, LW, VW, W, LS, banded);
    const int ovf = L0 < 0;
    if (tid == 0) {
        s_ovf = ovf; s_Vc = L0; s_head = 0; s_gs = 0;
        if (banded) k.rlo[0] = 0;              // row 0 stores [0, W)
    }
    if (!ovf) {
        row_zero(H, plane, RS, local, g, e, q, c, tid, NT);
        seed_par(k, bseqs, L0, bpaths, tid, NT);
    }
    __syncthreads();

    for (int r = 1; r < R && !s_ovf; ++r) {
        const int L = lens[r];
        if (L == 0) continue;
        for (int j = tid; j < L; j += NT) {
            s_seq[j] = bseqs[(size_t)r * LW + j];
            k.target[j] = -2;
        }
        // ---- topological walk: rows in list order (thread 0) ----
        if (tid == 0) s_V = topo_walk(k, s_head);
        __syncthreads();
        const int V = s_V;
        row_preds_par(k, V, tid, NT);
        __syncthreads();
        if (banded) {
            // min/max topological rank per row (abPOA band anchor)
            if (tid == 0) s_D = band_ranks(k, V);
            __syncthreads();
            // abPOA: the rank band widened by w = wb + wf L, shifted by the
            // longest rank D against L; wider than the window: overflow
            if (band_rows_par(k, V, L, pp[6] + (pp[7] * L) / 1000, s_D, tid,
                              NT) > W)
                s_ovf = 1;
            __syncthreads();
            if (s_ovf) break;
        }

        // ---- DP fill, one row per topological position ----
        int tbest = INT_MIN, trow = 0;        // local end cell, per thread
        int buf = 0;
        RowMeta cur = row_meta(k, 1, L, pcap, banded), nxt = cur;
        for (int i = 1; i <= V; ++i) {
            const int npr = cur.np > 0 ? cur.np : 1;
            const int c0 = cur.blo, bhi = cur.bhi;
            const int c1 = min(c0 + W - 1, L);
            int carry1 = NEG + e * max(c0 - 1, 0);
            int carry2 = NEG + c * max(c0 - 1, 0);
            int rowbest = INT_MIN;
            int32_t* Hi = H + (size_t)i * RS;
            for (int t0 = c0; t0 <= c1; t0 += TILE) {
                const int jb = t0 + tid * CPT;
                const int jl0 = jb - c0;      // stored column of jb
                int hq[CPT];
                int t1 = INT_MIN, t2 = INT_MIN;
                if (jb <= c1)
                    fill_hq<BANDED>(k, H, plane, RS, W, cur, npr, jb, jl0,
                                    c0, c1, bhi, s_seq, m, n, g, e, q, c,
                                    local, Hq + (size_t)i * RS,
                                    E1 + (size_t)i * RS,
                                    E2 + (size_t)i * RS, hq, t1, t2);
                // the next row's metadata, one level of independent loads
                // that land while this row scans and finishes
                if (t0 == c0 && i < V) nxt = row_meta(k, i + 1, L, pcap, banded);
                // block-wide exclusive prefix max of the thread totals
                int ex1, ex2, tot1, tot2;
                block_excl_max2(t1, t2, ex1, ex2, tot1, tot2, s_w1[buf],
                                s_w2[buf]);
                if (jb <= c1)
                    fill_h(hq, jb, jl0, c1, bhi, max(carry1, ex1),
                           max(carry2, ex2), g, e, q, c, rowbest, Hi);
                carry1 = max(carry1, tot1);
                carry2 = max(carry2, tot2);
                buf ^= 1;
            }
            if (rowbest > tbest) { tbest = rowbest; trow = i; }
            cur = nxt;
            __syncthreads();
        }

        // ---- end cell ----
        int ei = 0, ej = 0, have = 1;
        if (local) {
            reduce_best(tbest, trow, s_rv, s_rr);
            have = tbest > 0;
            ei = trow;
        } else {
            ei = sink_row(k, rd, H, V, L, s_rv, s_rr);
            ej = L;
        }

        // ---- traceback by value re-derivation (warp 0) ----
        if (tid < 32 && have) {
            const bool stuck = trace_warp<BANDED>(
                k, rd, H, Hq, E1, E2, s_seq, RS, ei, ej, tbest, local, m, n,
                g, e, q, c, lane);
            __syncwarp();
            if (stuck && lane == 0) s_ovf = 1;
        }

        // ---- threading: guarded aligned-ring reuse or a new node ----
        // Same thread as the traceback's lane 0 and no barrier in between:
        // s_ovf is only ever read by the other threads after the
        // end-of-round barrier, never in an interval where thread 0 may
        // write it.
        if (tid == 0 && !s_ovf) {
            int Vc = s_Vc, head = s_head, gs = s_gs;
            const int o = thread_seq(k, s_seq, L, VW, Vc, head, gs,
                                     bpaths + (size_t)r * LW);
            s_Vc = Vc; s_head = head; s_gs = gs;
            if (o) s_ovf = 1;
        }
        __syncthreads();
    }

    // ---- export ----
    export_block(k, bpaths, (size_t)RW * LW, exp_ + (size_t)b * 3 * VW,
                 meta + 4 * b, VW, R, s_ovf, s_Vc, s_head, s_gs, tid, NT,
                 tid == 0);
}

// ---- the cluster route: rows past one tile ----
//
// A POA block runs as one cluster of C thread blocks (CTAs), C = the row
// stride's tiles (`cluster_size`); CTA `rank` owns the stored columns
// [rank TILE, (rank + 1) TILE) of every row and fills them as the
// one-CTA kernel fills a tile.  What crosses a span's edge:
//   * the F channels' carry: after its block-wide scan a CTA pushes its
//     tile's totals to every CTA right of it that has columns in the row,
//     into their shared memory, each as a 64-bit word (row tag << 32 |
//     total) written whole, so the word is its own flag; a CTA waits for
//     the words of the CTAs left of it and takes the max with its own
//     carry.  Every push goes out before any wait, so the hand-off costs
//     one DSMEM trip, not C - 1.  One slot a source CTA is enough: the
//     row-end cluster barrier below lies between a row's reads and the
//     next row's pushes;
//   * the left halo (H at column jb - 1 of the predecessor rows, which
//     the CTA to the left wrote) and a banded row's predecessor windows
//     (any CTA's span): read from device memory after the cluster barrier
//     that ends every row (barrier.cluster arrive.release / wait.acquire
//     via cluster.sync), so every CTA's stores of the rows before are
//     visible to every CTA's loads of them.
// The round's graph work stays in CTA 0, as in the one-CTA kernel (the
// topological walk, the banded rank pass, the end cell's sink scan, the
// traceback in warp 0, the threading): the graph tables sit in the
// block's device scratch, and a cluster barrier publishes them.  The row
// metadata the fill reads every row (count, base, predecessor rows at 8
// slots, band) is replicated in every CTA's shared memory when it fits:
// 18 B a row (22 banded), 156,690 B at VW 8704 (191,510 banded), with the
// sequence (LS <= 10,240 B) and the control words (`CTL_BYTES`) <= 203 KB
// of the 227 KB a block may opt in to.  Each CTA derives its copy from the
// graph tables (`row_preds_par`, then the band from the ranks CTA 0
// computed).  At VW_MAX it would take 589,806 B, so there it stays in the
// device tables, written by the cluster's threads together and read by
// all after a barrier (`SMEM_META` = 0).  The graph tables themselves are
// 410 KiB at (8704, 8704, LS 4640) and 1.43 MiB at (VW_MAX, 8704): device
// memory, as on the one-CTA route past (4352, 2048).
constexpr int CLUSTER_MAX = 16;       // non-portable past 8: 32,768 columns
constexpr int CLUSTER_PORTABLE = 8;

// stored row's tiles: the cluster size; 1 = the one-CTA kernel
__host__ __device__ inline int cluster_size(int W, int LS, int banded) {
    const int s = row_stride(W, LS, banded);
    return s > TILE ? (s + TILE - 1) / TILE : 1;
}

// a CTA's control words, at the start of its dynamic shared memory (the
// emulation shares __shared__ statics between a cluster's blocks)
struct ClusterCtl {
    unsigned long long tot[CLUSTER_MAX][2];   // pushed: source CTA, channel
    int w1[2][NWARP], w2[2][NWARP];           // block_excl_max2's buffers
    int rv[NWARP], rr[NWARP];                 // reduce_best's
    int bv[CLUSTER_MAX], br[CLUSTER_MAX];     // CTA 0: each CTA's end cell
    int ovf, V, D, Vc, head, gs;
};
constexpr size_t CTL_BYTES = (sizeof(ClusterCtl) + 15) & ~(size_t)15;

// bytes of the row metadata in shared memory: int16 predecessor rows (and
// band), int8 count and base
__host__ __device__ inline size_t meta_bytes(size_t v1, int pcap,
                                             int banded) {
    return ((2 * (size_t)pcap + (banded ? 4 : 0) + 2) * v1 + 15)
         & ~(size_t)15;
}

__device__ __forceinline__ void put_word(unsigned long long* p,
                                         unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}
__device__ __forceinline__ unsigned long long get_word(
    const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// spin-wait hint: nothing on the card (the CPU emulation yields)
#ifndef SPIN_PAUSE
#define SPIN_PAUSE()
#endif

// The carry words of row tag `tag` that the CTAs left of `rank` pushed;
// folded into (carry1, carry2).  A hand-off that never comes is a fault
// of the kernel: the launch fails instead of hanging.
__device__ __forceinline__ void take_carry(const ClusterCtl* ctl, int rank,
                                           unsigned tag, int& carry1,
                                           int& carry2) {
    for (int s = 0; s < rank; ++s) {
        unsigned long long a, b;
        for (unsigned spin = 0;; ++spin) {
            a = get_word(&ctl->tot[s][0]);
            b = get_word(&ctl->tot[s][1]);
            if ((unsigned)(a >> 32) == tag && (unsigned)(b >> 32) == tag)
                break;
            if (spin > (1u << 28)) __trap();
            SPIN_PAUSE();
        }
        carry1 = max(carry1, (int)(unsigned)a);
        carry2 = max(carry2, (int)(unsigned)b);
    }
}

template <bool SMEM_META, bool BANDED>
__global__ void __launch_bounds__(NT, 2)
poa_win_cluster_kernel(const int8_t* __restrict__ seqs,
                       const int32_t* __restrict__ slen,
                       const int32_t* __restrict__ nseq,
                       const int32_t* __restrict__ params, int32_t* meta,
                       int32_t* exp_, int32_t* paths, int8_t* scratch,
                       int RW, int LW, int VW, int W, int pcap, int LS,
                       int local) {
    namespace cg = cooperative_groups;
    constexpr int banded = BANDED;
    const cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    // dynamic: the control words, the row metadata (SMEM_META), the
    // round's sequence (LS bytes)
    extern __shared__ int4 s_dyn[];
    ClusterCtl* ctl = (ClusterCtl*)s_dyn;
    int8_t* sm = (int8_t*)s_dyn + CTL_BYTES;

    const int b = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31;
    const int ctid = rank * NT + tid, cnt = C * NT;   // in the cluster
    const size_t v1 = (size_t)VW + 1;
    const int RS = row_stride(W, LS, banded);
    const size_t tb = table_bytes(v1, pcap, LS, banded);
    const size_t plane = v1 * (size_t)RS;
    int8_t* sc = scratch + (size_t)b * block_bytes(v1, pcap, W, LS, banded);
    Tables k;
    graph_carve(k, sc, v1, pcap, LS, banded);
    if (SMEM_META) {
        int16_t* w = (int16_t*)sm;
        k.rpreds = w;
        w += (size_t)pcap * v1;
        if (banded) { k.rlo = w; k.rhi = w + v1; w += 2 * v1; }
        k.rnp = (int8_t*)w;
        k.rbase = k.rnp + v1;
    }
    int8_t* s_seq = sm + (SMEM_META ? meta_bytes(v1, pcap, banded) : 0);
    int32_t* H = (int32_t*)(sc + tb);
    int32_t* Hq = H + plane;
    int32_t* E1 = Hq + plane;
    int32_t* E2 = E1 + plane;
    // a word of every CTA's control words (CTA 0's graph results, and
    // overflow, which any CTA may raise), written before a cluster barrier
    auto to_all = [&](int ClusterCtl::*f, int v) {
        for (int s = 0; s < C; ++s) cl.map_shared_rank(&(ctl->*f), s)[0] = v;
    };

    const int R = nseq[b];
    const int32_t* lens = slen + (size_t)b * RW;
    const int32_t* pp = params + (size_t)b * 8;
    const int m = pp[0], n = pp[1], g = pp[2], e = pp[3], q = pp[4],
              c = pp[5];
    const int8_t* bseqs = seqs + (size_t)b * RW * LW;
    int32_t* bpaths = paths + (size_t)b * RW * LW;

    auto rd = [&](const int32_t* pl, int row, int j) -> int32_t {
        const int jl = j - (banded ? (int)k.rlo[row] : 0);
        return (jl >= 0 && jl < W) ? pl[(size_t)row * RS + jl] : NEG;
    };

    // no CTA writes another's shared memory before the first barrier
    for (int x = tid; x < CLUSTER_MAX * 2; x += NT) ctl->tot[x / 2][x % 2] = 0;
    for (size_t x = ctid; x < (size_t)RW * LW; x += cnt) bpaths[x] = -1;
    const int L0 = capacity(lens, R, RW, LW, VW, W, LS, banded);
    if (tid == 0) {
        ctl->ovf = L0 < 0; ctl->Vc = L0; ctl->head = 0; ctl->gs = 0;
        if (banded && (SMEM_META || rank == 0)) k.rlo[0] = 0;
    }
    cl.sync();
    if (L0 >= 0) {
        row_zero(H, plane, RS, local, g, e, q, c, ctid, cnt);
        seed_par(k, bseqs, L0, bpaths, ctid, cnt);
    }
    cl.sync();

    unsigned tag = 0;                     // DP rows so far: the carry tag
    for (int r = 1; r < R && !ctl->ovf; ++r) {
        const int L = lens[r];
        if (L == 0) continue;
        for (int j = tid; j < L; j += NT) {
            s_seq[j] = bseqs[(size_t)r * LW + j];
            if (rank == 0) k.target[j] = -2;
        }
        if (rank == 0 && tid == 0)
            to_all(&ClusterCtl::V, topo_walk(k, ctl->head));
        cl.sync();
        const int V = ctl->V;
        // the row metadata: each CTA its own copy, or the device tables
        // by the whole cluster
        const int first = SMEM_META ? tid : ctid;
        const int stride = SMEM_META ? NT : cnt;
        row_preds_par(k, V, first, stride);
        if (SMEM_META) __syncthreads(); else cl.sync();
        if (banded) {
            if (rank == 0 && tid == 0)
                to_all(&ClusterCtl::D, band_ranks(k, V));
            cl.sync();
            if (band_rows_par(k, V, L, pp[6] + (pp[7] * L) / 1000, ctl->D,
                              first, stride) > W)
                to_all(&ClusterCtl::ovf, 1);
            cl.sync();
            if (ctl->ovf) break;
        }

        // ---- DP fill: every row on every CTA with columns in it ----
        int tbest = INT_MIN, trow = 0;
        int buf = 0;
        RowMeta cur = row_meta(k, 1, L, pcap, banded), nxt = cur;
        for (int i = 1; i <= V; ++i) {
            ++tag;
            const int npr = cur.np > 0 ? cur.np : 1;
            const int c0 = cur.blo, bhi = cur.bhi;
            const int c1 = min(c0 + W - 1, L);
            const int active = (c1 - c0) / TILE + 1;   // CTAs with columns
            int rowbest = INT_MIN;
            if (rank < active) {
                const int jb = c0 + rank * TILE + tid * CPT;
                const int jl0 = jb - c0;
                int hq[CPT];
                int t1 = INT_MIN, t2 = INT_MIN;
                if (jb <= c1)
                    fill_hq<BANDED>(k, H, plane, RS, W, cur, npr, jb, jl0,
                                    c0, c1, bhi, s_seq, m, n, g, e, q, c,
                                    local, Hq + (size_t)i * RS,
                                    E1 + (size_t)i * RS,
                                    E2 + (size_t)i * RS, hq, t1, t2);
                if (i < V) nxt = row_meta(k, i + 1, L, pcap, banded);
                int ex1, ex2, tot1, tot2;
                block_excl_max2(t1, t2, ex1, ex2, tot1, tot2, ctl->w1[buf],
                                ctl->w2[buf]);
                buf ^= 1;
                if (tid == 0) {
                    const unsigned long long hi =
                        (unsigned long long)tag << 32;
                    for (int s = rank + 1; s < active; ++s) {
                        unsigned long long* d =
                            cl.map_shared_rank(&ctl->tot[rank][0], s);
                        put_word(d, hi | (unsigned)tot1);
                        put_word(d + 1, hi | (unsigned)tot2);
                    }
                }
                int carry1 = NEG + e * max(c0 - 1, 0);
                int carry2 = NEG + c * max(c0 - 1, 0);
                take_carry(ctl, rank, tag, carry1, carry2);
                if (jb <= c1)
                    fill_h(hq, jb, jl0, c1, bhi, max(carry1, ex1),
                           max(carry2, ex2), g, e, q, c, rowbest,
                           H + (size_t)i * RS);
            } else if (i < V) {
                nxt = row_meta(k, i + 1, L, pcap, banded);
            }
            if (rowbest > tbest) { tbest = rowbest; trow = i; }
            cur = nxt;
            cl.sync();
        }

        // ---- end cell: the best of each CTA's, ties to the lower row ----
        int ei = 0, ej = 0, have = 1;
        if (local) {
            reduce_best(tbest, trow, ctl->rv, ctl->rr);
            if (tid == 0) {
                cl.map_shared_rank(&ctl->bv[rank], 0)[0] = tbest;
                cl.map_shared_rank(&ctl->br[rank], 0)[0] = trow;
            }
            cl.sync();
            if (rank == 0) {
                tbest = ctl->bv[0]; trow = ctl->br[0];
                for (int s = 1; s < C; ++s)
                    if (ctl->bv[s] > tbest ||
                        (ctl->bv[s] == tbest && ctl->br[s] < trow)) {
                        tbest = ctl->bv[s]; trow = ctl->br[s];
                    }
            }
            have = tbest > 0;
            ei = trow;
        } else if (rank == 0) {
            ei = sink_row(k, rd, H, V, L, ctl->rv, ctl->rr);
            ej = L;
        }

        // ---- traceback (CTA 0's warp 0) and threading (its thread 0) ----
        if (rank == 0 && tid < 32 && have) {
            const bool stuck = trace_warp<BANDED>(
                k, rd, H, Hq, E1, E2, s_seq, RS, ei, ej, tbest, local, m, n,
                g, e, q, c, lane);
            __syncwarp();
            if (stuck && lane == 0) to_all(&ClusterCtl::ovf, 1);
        }
        if (rank == 0 && tid == 0 && !ctl->ovf) {
            int Vc = ctl->Vc, head = ctl->head, gs = ctl->gs;
            const int o = thread_seq(k, s_seq, L, VW, Vc, head, gs,
                                     bpaths + (size_t)r * LW);
            ctl->Vc = Vc; ctl->head = head; ctl->gs = gs;
            if (o) to_all(&ClusterCtl::ovf, 1);
        }
        cl.sync();
    }

    // ---- export: CTA 0, or an overflowed block's by the whole cluster ----
    export_block(k, bpaths, (size_t)RW * LW, exp_ + (size_t)b * 3 * VW,
                 meta + 4 * b, VW, R, ctl->ovf, ctl->Vc, ctl->head, ctl->gs,
                 ctl->ovf ? ctid : rank == 0 ? tid : VW,
                 ctl->ovf ? cnt : NT, rank == 0 && tid == 0);
    cl.sync();            // no CTA leaves while another reads its words
}

inline cudaError_t win_geometry(int B, int VW, int pcap, int LS, int banded,
                                Geometry& g) {
    return one_block_geometry(B, table_bytes((size_t)VW + 1, pcap, LS,
                                             banded),
                              LS, STATIC_SMEM, g);
}

// The cluster route's geometry: C CTAs a POA block, the graph tables in
// device scratch (`tables` = 0), the row metadata in shared memory when
// it fits beside the sequence and the control words in what one block may
// opt in to (`meta` = 1), else in the device tables.
inline cudaError_t cluster_geometry(int B, int VW, int pcap, int LS,
                                    int banded, int C, Geometry& g,
                                    int& meta) {
    int sms = 0, smem_block = 0, smem_sm = 0;
    const cudaError_t err = device_limits(sms, smem_block, smem_sm);
    if (err != cudaSuccess) return err;
    long budget = smem_sm - 1024;                  // 1 KB per block reserved
    if (budget > smem_block) budget = smem_block;
    budget -= STATIC_SMEM;
    const size_t base = CTL_BYTES + (size_t)LS;
    const size_t mb = meta_bytes((size_t)VW + 1, pcap, banded);
    if ((long)base > budget) return cudaErrorInvalidValue;
    meta = (long)(base + mb) <= budget;
    g.tables = 0;
    g.per_block = 1;
    g.grid = B * C;
    g.smem = (int)(base + (meta ? mb : 0));
    return cudaSuccess;
}

template <bool T, bool BD>
cudaError_t launch_win(const Geometry& geo, const void* seqs,
                       const void* slen, const void* nseq, const void* params,
                       void* meta, void* exp_, void* paths, void* scratch,
                       int RW, int LW, int VW, int W, int pcap, int LS,
                       int local, cudaStream_t stream) {
    const cudaError_t err = opt_in_smem(poa_win_kernel<T, BD>, geo.smem);
    if (err != cudaSuccess) return err;
    poa_win_kernel<T, BD><<<geo.grid, NT, geo.smem, stream>>>(
        (const int8_t*)seqs, (const int32_t*)slen, (const int32_t*)nseq,
        (const int32_t*)params, (int32_t*)meta, (int32_t*)exp_,
        (int32_t*)paths, (int8_t*)scratch, RW, LW, VW, W, pcap, LS, local);
    return cudaGetLastError();
}

// A cluster launch: refused (an error, never another route) when the card
// cannot hold one cluster of this shape at once
template <bool M, bool BD>
cudaError_t launch_cluster(const Geometry& geo, int C, const void* seqs,
                           const void* slen, const void* nseq,
                           const void* params, void* meta, void* exp_,
                           void* paths, void* scratch, int RW, int LW,
                           int VW, int W, int pcap, int LS, int local,
                           cudaStream_t stream) {
    auto kern = poa_win_cluster_kernel<M, BD>;
    cudaError_t err = opt_in_smem(kern, geo.smem);
    if (err == cudaSuccess && C > CLUSTER_PORTABLE)
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3{(unsigned)geo.grid, 1, 1};
    cfg.blockDim = dim3{(unsigned)NT, 1, 1};
    cfg.dynamicSmemBytes = geo.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&cfg, kern, (const int8_t*)seqs,
                             (const int32_t*)slen, (const int32_t*)nseq,
                             (const int32_t*)params, (int32_t*)meta,
                             (int32_t*)exp_, (int32_t*)paths,
                             (int8_t*)scratch, RW, LW, VW, W, pcap, LS,
                             local);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// int16 tables: node ids up to VW_MAX and (banded) band columns below
// 2^15; at most CLUSTER_MAX tiles a stored row
inline bool bad_shape(int LW, int VW, int W, int pcap, int LS, int banded) {
    return pcap < 1 || pcap > PCAP_MAX || VW < 1 || VW > VW_MAX || W < 1 ||
           LS < 32 || LS % 32 != 0 || (banded && LW > 32768) ||
           cluster_size(W, LS, banded) > CLUSTER_MAX;
}

// the launch's geometry by its route
inline cudaError_t route_geometry(int B, int VW, int W, int pcap, int LS,
                                  int banded, Geometry& g, int& C,
                                  int& meta) {
    C = cluster_size(W, LS, banded);
    meta = 0;
    return C > 1 ? cluster_geometry(B, VW, pcap, LS, banded, C, g, meta)
                 : win_geometry(B, VW, pcap, LS, banded, g);
}

}  // namespace

extern "C" {

// The launch geometry of `B` POA blocks at these capacities, stored window
// W and row stride on the current device: out = (POA blocks per thread
// block (1), grid, dynamic shared bytes, graph tables in shared memory,
// cluster size (1: the one-CTA kernel), row metadata in shared memory (the
// cluster route)).  Returns a CUDA error.
int poa_win_geometry(int B, int VW, int W, int pcap, int LS, int banded,
                     int* out) {
    if (B <= 0 || bad_shape(2, VW, W, pcap, LS, banded))
        return (int)cudaErrorInvalidValue;
    Geometry g;
    int C = 1, meta = 0;
    const cudaError_t err = route_geometry(B, VW, W, pcap, LS, banded, g, C,
                                           meta);
    if (err == cudaSuccess) {
        geometry_out(g, out);
        out[4] = C;
        out[5] = meta;
    }
    return (int)err;
}

// Launch on `stream` (PyTorch's current stream) in the geometry above,
// with full-width DP rows of LS columns (a multiple of 32 above every
// sequence length that fits LW, ops/poa_win.py:row_stride), banded rows of
// W (rounded up to 8), and `scratch` holding B blocks of block_bytes.  A
// stored row past one tile takes the cluster route.  Returns
// cudaGetLastError() after the launch: nonzero means the launch was
// refused (a cluster too, when the card holds none of its shape) or an
// earlier asynchronous fault is pending, and the caller raises.
int poa_win_launch(const void* seqs, const void* slen, const void* nseq,
                   const void* params, void* meta, void* exp_, void* paths,
                   void* scratch, int B, int RW, int LW, int VW, int W,
                   int pcap, int LS, int local, int banded, void* stream) {
    if (B <= 0) return 0;
    if (bad_shape(LW, VW, W, pcap, LS, banded))
        return (int)cudaErrorInvalidValue;
    Geometry geo;
    int C = 1, sm = 0;
    const cudaError_t err = route_geometry(B, VW, W, pcap, LS, banded, geo,
                                           C, sm);
    if (err != cudaSuccess) return (int)err;
    if (C > 1) {
        auto fn = sm ? (banded ? launch_cluster<true, true>
                               : launch_cluster<true, false>)
                     : (banded ? launch_cluster<false, true>
                               : launch_cluster<false, false>);
        return (int)fn(geo, C, seqs, slen, nseq, params, meta, exp_, paths,
                       scratch, RW, LW, VW, W, pcap, LS, local,
                       (cudaStream_t)stream);
    }
    auto fn = geo.tables ? (banded ? launch_win<true, true>
                                   : launch_win<true, false>)
                         : (banded ? launch_win<false, true>
                                   : launch_win<false, false>);
    return (int)fn(geo, seqs, slen, nseq, params, meta, exp_, paths, scratch,
                   RW, LW, VW, W, pcap, LS, local, (cudaStream_t)stream);
}

// Load every instantiation of the two kernels on the current device now.
// Under CUDA's lazy module loading a function is loaded at its first use,
// and that load waits for the kernels then running: a chunk's first launch
// of an instantiation beside another chunk's running kernel held the host
// until that kernel ended (1.9 s at -l 4000 on 90 haplotypes).  Returns a
// CUDA error.
int poa_win_prepare() {
    const void* fns[] = {
        (const void*)poa_win_kernel<false, false>,
        (const void*)poa_win_kernel<false, true>,
        (const void*)poa_win_kernel<true, false>,
        (const void*)poa_win_kernel<true, true>,
        (const void*)poa_win_cluster_kernel<false, false>,
        (const void*)poa_win_cluster_kernel<false, true>,
        (const void*)poa_win_cluster_kernel<true, false>,
        (const void*)poa_win_cluster_kernel<true, true>};
    for (const void* fn : fns) {
        cudaFuncAttributes attr;
        const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

const char* poa_win_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
