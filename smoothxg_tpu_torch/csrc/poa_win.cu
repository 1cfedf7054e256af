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
// What bounds it on this card.  The algorithm has one parallel axis — the
// columns of a DP row — wrapped in scalar graph work:
//   * the fill: per row, up to pcap predecessor rows are read from device
//     memory (they were written a few rows earlier, so they come from L2),
//     the F channels need a block-wide prefix max, and the next row may
//     read this one, so every row ends in a barrier.  Cost per row is one
//     barrier per 2048-column tile plus one, and a couple of dependent L2
//     round trips for the row's metadata;
//   * the topological walk, the banded rank pass, the traceback and the
//     threading are dependent chains of global loads (node tables live in
//     device memory and stay resident in L2), run by thread 0 between
//     barriers.
// What the design does about it: per-row metadata (node, predecessor rows,
// band) is precomputed once per round into row tables, in parallel where
// the dependency allows, so each DP row starts with independent loads; the
// F channels use the closed form F(j) = max_{k<j}(hq(k) + ext*k) - open -
// ext*(j-1) as a warp-shuffle scan plus a scan of per-warp totals, with
// the warp totals double-buffered so a tile needs one barrier; the local
// end cell is tracked per thread during the fill and reduced once.
// Parallelism across POA blocks comes from the grid: one thread block per
// POA block, so a launch needs a batch of >= 132 blocks to fill the SMs.
// Scores are int32 with the floor NEG = -2^30 (no int16 clamp), and the DP
// planes (H, Hq, E1, E2: 16 bytes per cell) live in device memory.  The
// graph side (tables, seed, walk, rank pass, threading, export) is
// poa_graph.cuh's, shared with poa_code.cu and poa_stacked.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
//        -fPIC, one process per source, then one link into a shared
//        library (smoothxg_tpu_torch/ops/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "poa_common.cuh"
#include "poa_graph.cuh"

namespace {

// Per-block scratch: the graph tables (poa_graph.cuh), then the DP planes
// H Hq E1 E2, each (VW + 1) x W int32 — mirrored by WinCaps.scratch_words
// in ops/poa_win.py.

__device__ __forceinline__ int32_t rd(const int32_t* plane, int W,
                                      const int32_t* rlo, int row, int j) {
    // column j of DP row `row`; cells outside the stored window are the
    // floor by banded semantics (the window covers the whole band)
    int jl = j - rlo[row];
    return (jl >= 0 && jl < W) ? plane[(size_t)row * W + jl] : NEG;
}

__global__ void __launch_bounds__(NT)
poa_win_kernel(const int8_t* __restrict__ seqs, const int32_t* __restrict__ slen,
               const int32_t* __restrict__ nseq, const int32_t* __restrict__ params,
               int32_t* meta, int32_t* exp_, int32_t* paths, int32_t* scratch,
               int RW, int LW, int VW, int W, int pcap, int local, int banded) {
    extern __shared__ int8_t s_seq[];        // the round's sequence, LW bytes
    __shared__ int s_w1[2][NWARP], s_w2[2][NWARP];
    __shared__ int s_rv[NWARP], s_rr[NWARP];
    __shared__ int s_ovf, s_V, s_Vc, s_head, s_gs, s_D;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t v1 = (size_t)VW + 1;
    const size_t plane = v1 * (size_t)W;
    int32_t* sc = scratch + (size_t)b * (graph_words(v1, pcap, LW) + 4 * plane);
    Graph k;
    int32_t* H = graph_carve(k, sc, v1, pcap, LW);
    int32_t* Hq = H + plane;
    int32_t* E1 = Hq + plane;
    int32_t* E2 = E1 + plane;

    const int R = nseq[b];
    const int32_t* lens = slen + (size_t)b * RW;
    const int32_t* pp = params + (size_t)b * 8;
    const int m = pp[0], n = pp[1], g = pp[2], e = pp[3], q = pp[4],
              c = pp[5], wb = pp[6], wfm = pp[7];
    const int8_t* bseqs = seqs + (size_t)b * RW * LW;
    int32_t* bpaths = paths + (size_t)b * RW * LW;
    int32_t* bexp = exp_ + (size_t)b * 3 * VW;

    for (size_t x = tid; x < (size_t)RW * LW; x += NT) bpaths[x] = -1;
    __syncthreads();

    // ---- capacity check (every thread computes the same verdict) ----
    int ovf = (R < 1 || R > RW);
    int L0 = 0;
    if (!ovf) {
        L0 = lens[0];
        int maxL = 0;
        for (int r = 0; r < R; ++r) maxL = max(maxL, lens[r]);
        ovf = L0 < 1 || L0 > VW || maxL > LW - 1
            || (!banded && maxL + 1 > W);
    }
    if (tid == 0) {
        s_ovf = ovf; s_Vc = L0; s_head = 0; s_gs = 0;
        k.rlo[0] = 0;                          // row 0 stores [0, W)
    }
    if (!ovf) {
        // row 0: the virtual source
        for (int jl = tid; jl < W; jl += NT) {
            int32_t h, hq;
            if (local) { h = 0; hq = 0; }
            else if (jl == 0) { h = 0; hq = 0; }
            else {
                h = max(-(g + (jl - 1) * e), -(q + (jl - 1) * c));
                hq = NEG;
            }
            H[jl] = h; Hq[jl] = hq; E1[jl] = NEG; E2[jl] = NEG;
        }
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
            const int w = wb + (wfm * L) / 1000;
            const int adj_l = max(0, s_D - L), adj_r = max(0, L - s_D);
            for (int i = 1 + tid; i <= V; i += NT) {
                int lo = max(0, k.rmr[i] - w - adj_l);
                int hi = min(L, k.rMr[i] + w + adj_r);
                k.rlo[i] = lo; k.rhi[i] = hi;
                if (hi - lo + 1 > W) s_ovf = 1;   // band wider than window
            }
        } else {
            for (int i = 1 + tid; i <= V; i += NT) { k.rlo[i] = 0; k.rhi[i] = L; }
        }
        __syncthreads();
        if (s_ovf) break;

        // ---- DP fill, one row per topological position ----
        int tbest = INT_MIN, trow = 0;        // local end cell, per thread
        int buf = 0;
        for (int i = 1; i <= V; ++i) {
            const int v = k.rnode[i];
            const int np = k.rnp[i];
            const int bv = k.base[v];
            const int c0 = k.rlo[i], bhi = k.rhi[i];
            const int c1 = min(c0 + W - 1, L);
            int prow[8], poff[8];
            const int npr = np > 0 ? np : 1;
            for (int p = 0; p < npr; ++p) {
                prow[p] = np > 0 ? k.rpreds[(size_t)i * pcap + p] : 0;
                poff[p] = k.rlo[prow[p]];
            }
            int carry1 = NEG + e * max(c0 - 1, 0);
            int carry2 = NEG + c * max(c0 - 1, 0);
            int rowbest = INT_MIN;
            int32_t* Hi = H + (size_t)i * W;
            int32_t* Hqi = Hq + (size_t)i * W;
            int32_t* E1i = E1 + (size_t)i * W;
            int32_t* E2i = E2 + (size_t)i * W;
            for (int t0 = c0; t0 <= c1; t0 += TILE) {
                const int jb = t0 + tid * CPT;
                int hp[CPT + 1], hq[CPT];
                int t1 = INT_MIN, t2 = INT_MIN;
                for (int x = 0; x <= CPT; ++x) hp[x] = NEG;
                int x1[CPT], x2[CPT];
                for (int x = 0; x < CPT; ++x) { x1[x] = NEG; x2[x] = NEG; }
                if (jb <= c1) {
                    for (int p = 0; p < npr; ++p) {
                        const size_t rb = (size_t)prow[p] * W;
                        for (int x = 0; x <= CPT; ++x) {
                            int jl = jb - 1 + x - poff[p];
                            if (jb - 1 + x <= c1 && jl >= 0 && jl < W)
                                hp[x] = max(hp[x], H[rb + jl]);
                        }
                        for (int x = 0; x < CPT; ++x) {
                            int jl = jb + x - poff[p];
                            if (jb + x <= c1 && jl >= 0 && jl < W) {
                                x1[x] = max(x1[x], E1[rb + jl]);
                                x2[x] = max(x2[x], E2[rb + jl]);
                            }
                        }
                    }
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        if (j > c1) { hq[x] = NEG; continue; }
                        int M = j == 0 ? NEG
                            : hp[x] + ((int)s_seq[j - 1] == bv ? m : -n);
                        int e1 = max(max(hp[x + 1] - g, x1[x] - e), NEG);
                        int e2 = max(max(hp[x + 1] - q, x2[x] - c), NEG);
                        int h = max(M, max(e1, e2));
                        if (local) h = max(h, 0);
                        if (j < c0 || j > bhi) { h = NEG; e1 = NEG; e2 = NEG; }
                        hq[x] = h;
                        Hqi[j - c0] = h; E1i[j - c0] = e1; E2i[j - c0] = e2;
                        t1 = max(t1, h + e * j);
                        t2 = max(t2, h + c * j);
                    }
                }
                // block-wide exclusive prefix max of the thread totals
                int ex1, ex2, tot1, tot2;
                block_excl_max2(t1, t2, ex1, ex2, tot1, tot2, s_w1[buf],
                                s_w2[buf]);
                int g1 = max(carry1, ex1), g2 = max(carry2, ex2);
                if (jb <= c1) {
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        if (j > c1) break;
                        int h = hq[x];
                        if (j > 0) {
                            int f1 = g1 - g - e * (j - 1);
                            int f2 = g2 - q - c * (j - 1);
                            h = max(h, max(f1, f2));
                        }
                        g1 = max(g1, hq[x] + e * j);
                        g2 = max(g2, hq[x] + c * j);
                        if (j > bhi) h = NEG;     // (j >= c0 = band floor)
                        else rowbest = max(rowbest, h);
                        Hi[j - c0] = h;
                    }
                }
                carry1 = max(carry1, tot1);
                carry2 = max(carry2, tot2);
                buf ^= 1;
            }
            if (rowbest > tbest) { tbest = rowbest; trow = i; }
            __syncthreads();
        }

        // ---- end cell ----
        int ei = 0, ej = 0, have = 1;
        if (local) {
            reduce_best(tbest, trow, s_rv, s_rr);
            have = tbest > 0;
            ei = trow;
        } else {
            int hb = NEG - 1, hr = 0;
            for (int i = 1 + tid; i <= V; i += NT) {
                if (k.nsucc[k.rnode[i]] != 0) continue;
                int h = rd(H, W, k.rlo, i, L);
                if (h > hb) { hb = h; hr = i; }
            }
            if (hr == 0) hr = INT_MAX;           // no sink in this thread
            reduce_best(hb, hr, s_rv, s_rr);
            ei = hr == INT_MAX ? 0 : hr;      // (a DAG always has a sink)
            ej = L;
        }

        if (tid == 0 && have) {
            if (local) {
                const int32_t* row = H + (size_t)ei * W;
                int jl = 0;
                while (row[jl] != tbest) ++jl;
                ej = k.rlo[ei] + jl;
            }
            // ---- traceback by value re-derivation (thread 0) ----
            int i = ei, j = ej, chan = 0;     // 0 H, 1 Hq, 2 E1, 3 E2
            int val = rd(H, W, k.rlo, i, j);
            while (true) {
                if (chan <= 1) {
                    if (local && val == 0) break;
                    if (i == 0) {
                        if (j == 0) break;
                        k.target[j - 1] = -1;     // leading insertion
                        --j;
                        val = rd(H, W, k.rlo, 0, j);
                        chan = 0;
                        continue;
                    }
                    const int v = k.rnode[i];
                    const int np = k.rnp[i], npr = np > 0 ? np : 1;
                    bool moved = false;
                    if (j > 0) {
                        int subv = (int)s_seq[j - 1] == k.base[v] ? m : -n;
                        for (int p = 0; p < npr; ++p) {
                            int pr = np > 0 ? k.rpreds[(size_t)i * pcap + p] : 0;
                            if (rd(H, W, k.rlo, pr, j - 1) + subv == val) {
                                k.target[j - 1] = v;
                                i = pr; --j; chan = 0;
                                val = rd(H, W, k.rlo, i, j);
                                moved = true;
                                break;
                            }
                        }
                    }
                    if (moved) continue;
                    if (rd(E1, W, k.rlo, i, j) == val) { chan = 2; continue; }
                    if (rd(E2, W, k.rlo, i, j) == val) { chan = 3; continue; }
                    if (chan == 0) {
                        int kf = -1;
                        for (int kk = j - 1; kk >= 0; --kk) {
                            int h = rd(Hq, W, k.rlo, i, kk);
                            if (h - g - (j - 1 - kk) * e == val ||
                                h - q - (j - 1 - kk) * c == val) { kf = kk; break; }
                        }
                        if (kf >= 0) {
                            for (int t = kf; t < j; ++t) k.target[t] = -1;
                            j = kf; chan = 1;
                            val = rd(Hq, W, k.rlo, i, j);
                            continue;
                        }
                    }
                    s_ovf = 1;                    // stuck: cannot happen
                    break;
                }
                const int op = chan == 2 ? g : q, ex = chan == 2 ? e : c;
                const int32_t* Em = chan == 2 ? E1 : E2;
                const int np = k.rnp[i], npr = np > 0 ? np : 1;
                int nxt_i = -1, nxt_val = 0, nxt_chan = chan;
                for (int p = 0; p < npr; ++p) {
                    int pr = np > 0 ? k.rpreds[(size_t)i * pcap + p] : 0;
                    int h = rd(H, W, k.rlo, pr, j);
                    if (h - op == val) { nxt_i = pr; nxt_val = h; nxt_chan = 0; break; }
                }
                if (nxt_i < 0) {
                    for (int p = 0; p < npr; ++p) {
                        int pr = np > 0 ? k.rpreds[(size_t)i * pcap + p] : 0;
                        int x = rd(Em, W, k.rlo, pr, j);
                        if (x - ex == val) { nxt_i = pr; nxt_val = x; break; }
                    }
                }
                if (nxt_i < 0) { s_ovf = 1; break; }   // broken E chain
                i = nxt_i; val = nxt_val; chan = nxt_chan;
            }
        }

        // ---- threading: guarded aligned-ring reuse or a new node ----
        // Same thread as the traceback and no barrier in between: s_ovf is
        // only ever read by the other threads after the end-of-round
        // barrier, never in an interval where thread 0 may write it.
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
    if (s_ovf) {
        export_overflow_par(bpaths, (size_t)RW * LW, bexp, VW, tid, NT);
        if (tid == 0) {
            meta[4 * b] = 0; meta[4 * b + 1] = 1;
            meta[4 * b + 2] = R; meta[4 * b + 3] = 0;
        }
        return;
    }
    export_nodes_par(k, bexp, VW, s_Vc, tid, NT);
    if (tid == 0) {
        export_order(k, bexp, VW, s_Vc, s_head);
        meta[4 * b] = s_Vc; meta[4 * b + 1] = 0;
        meta[4 * b + 2] = R; meta[4 * b + 3] = s_gs;
    }
}

}  // namespace

extern "C" {

// Launch on `stream` (PyTorch's current stream).  Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused or an earlier
// asynchronous fault is pending, and the caller raises.
int poa_win_launch(const void* seqs, const void* slen, const void* nseq,
                   const void* params, void* meta, void* exp_, void* paths,
                   void* scratch, int B, int RW, int LW, int VW, int W,
                   int pcap, int local, int banded, void* stream) {
    if (B <= 0) return 0;
    if (pcap < 1 || pcap > 8) return (int)cudaErrorInvalidValue;
    size_t smem = ((size_t)LW + 15) & ~(size_t)15;
    poa_win_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
        (const int8_t*)seqs, (const int32_t*)slen, (const int32_t*)nseq,
        (const int32_t*)params, (int32_t*)meta, (int32_t*)exp_,
        (int32_t*)paths, (int32_t*)scratch, RW, LW, VW, W, pcap, local,
        banded);
    return (int)cudaGetLastError();
}

const char* poa_win_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
