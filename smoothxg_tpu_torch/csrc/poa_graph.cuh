// poa_graph.cuh — the graph side of the code-chase whole-block POA kernels
// (poa_code.cu: one thread block per POA block; poa_stacked.cu: one warp
// per POA block): the per-block scratch tables, the seed chain, the
// topological walk, the rank band, the code word and its chase, the
// guarded aligned-ring threading and the export.  The semantics are
// poa_win.cu's (FusedPOA + ops/poa_host), written once for both kernels.
// Routines named *_par are run by every thread of a group (`first` is the
// thread's rank in the group, `stride` the group's size); the others by one
// thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "poa_common.cuh"

namespace {

constexpr int RING_CAP = 8;

// Provenance code word with SB-bit predecessor slot fields: SB = 7 is the
// int32 word of smoothxg_tpu/ops/poa_pallas_fused.py:403-409, SB = 2 the
// CODE16 of poa_pallas_stacked.py:433-442 (ops/poa_code.py:CodeLayout).
template <int SB>
struct CodeLayout {
    static constexpr int SLOT = (1 << SB) - 1;
    static constexpr int E1S = SB, E1O = 2 * SB;
    static constexpr int E2S = 2 * SB + 1, E2O = 3 * SB + 1;
    static constexpr int SEL = 3 * SB + 2;
    static constexpr int HQEQ = 3 * SB + 4, F1H = 3 * SB + 5,
                         F2H = 3 * SB + 6;
    static constexpr int F1N = 3 * SB + 7, F2N = 3 * SB + 8,
                         HQZ = 3 * SB + 9;
};

// Per-block scratch tables, int32 words (v1 = VW + 1):
//   node tables  base pos ring nxt npred nsucc      6 * v1
//                preds                              pcap * v1
//   row tables   node np lo hi mr Mr                6 * v1
//                pred rows                          pcap * v1
//   target (LW), ring splices (2 * LW)              3 * LW
// followed by the kernel's DP planes.  Rows are indexed by topological
// position (row 0 = the virtual source), so a fill writes its rows in
// order and a predecessor row is pos[pred] + 1.
struct Graph {
    int32_t *base, *pos, *ring, *nxt, *npred, *nsucc, *preds;
    int32_t *rnode, *rnp, *rlo, *rhi, *rmr, *rMr, *rpreds;
    int32_t *target, *spl;
    int pcap;
};

__host__ __device__ inline size_t graph_words(size_t v1, int pcap, int LW) {
    return (12 + 2 * (size_t)pcap) * v1 + 3 * (size_t)LW;
}

// carve the tables out of `sc`; returns the first word past them
__device__ inline int32_t* graph_carve(Graph& k, int32_t* sc, size_t v1,
                                       int pcap, int LW) {
    k.pcap = pcap;
    k.base = sc;          k.pos = sc + v1;       k.ring = sc + 2 * v1;
    k.nxt = sc + 3 * v1;  k.npred = sc + 4 * v1; k.nsucc = sc + 5 * v1;
    k.preds = sc + 6 * v1;
    int32_t* rt = sc + (6 + pcap) * v1;
    k.rnode = rt;         k.rnp = rt + v1;       k.rlo = rt + 2 * v1;
    k.rhi = rt + 3 * v1;  k.rmr = rt + 4 * v1;   k.rMr = rt + 5 * v1;
    k.rpreds = rt + 6 * v1;
    k.target = sc + (12 + 2 * pcap) * v1;
    k.spl = k.target + LW;
    return sc + graph_words(v1, pcap, LW);
}

// predecessor row of slot s of row i (a node without predecessors reads
// row 0, the virtual source)
__device__ __forceinline__ int pred_row(const Graph& k, int i, int s) {
    return k.rnp[i] > 0 ? k.rpreds[(size_t)i * k.pcap + s] : 0;
}

// seed: sequence 0 becomes a chain of L0 nodes
__device__ void seed_par(Graph& k, const int8_t* seq0, int L0,
                         int32_t* path0, int first, int stride) {
    for (int v = first; v < L0; v += stride) {
        k.base[v] = seq0[v];
        k.pos[v] = v;
        k.ring[v] = v;
        k.nxt[v] = v < L0 - 1 ? v + 1 : -1;
        k.npred[v] = v >= 1 ? 1 : 0;
        k.preds[(size_t)v * k.pcap] = v - 1;
        k.nsucc[v] = v < L0 - 1 ? 1 : 0;
        path0[v] = v;
    }
}

// rows in list order (the list is kept topological); returns V
__device__ int topo_walk(Graph& k, int head) {
    int i = 0;
    for (int v = head; v >= 0; v = k.nxt[v]) {
        k.pos[v] = i;
        k.rnode[++i] = v;
    }
    return i;
}

// node count and predecessor rows of every row
__device__ void row_preds_par(Graph& k, int V, int first, int stride) {
    for (int i = 1 + first; i <= V; i += stride) {
        const int v = k.rnode[i];
        const int np = k.npred[v];
        k.rnp[i] = np;
        for (int p = 0; p < np; ++p)
            k.rpreds[(size_t)i * k.pcap + p] =
                k.pos[k.preds[(size_t)v * k.pcap + p]] + 1;
    }
}

// min/max topological rank per row (the abPOA band anchor); returns the
// longest rank D
__device__ int band_ranks(Graph& k, int V) {
    int D = 0;
    for (int i = 1; i <= V; ++i) {
        const int np = k.rnp[i];
        int mr = 1, Mr = 1;
        if (np > 0) {
            int lo = 1 << 28, hi = 0;
            for (int p = 0; p < np; ++p) {
                const int u = k.rpreds[(size_t)i * k.pcap + p];
                lo = min(lo, k.rmr[u]);
                hi = max(hi, k.rMr[u]);
            }
            mr = lo + 1;
            Mr = hi + 1;
        }
        k.rmr[i] = mr;
        k.rMr[i] = Mr;
        D = max(D, Mr);
    }
    return D;
}

// the band [lo, hi] of every row: [0, L] unbanded, else the adaptive band
// around the row's rank (rows stay full width, so no band overflows)
__device__ void band_rows_par(Graph& k, int V, int L, int banded, int w,
                              int D, int first, int stride) {
    const int adj_l = max(0, D - L), adj_r = max(0, L - D);
    for (int i = 1 + first; i <= V; i += stride) {
        k.rlo[i] = banded ? max(0, k.rmr[i] - w - adj_l) : 0;
        k.rhi[i] = banded ? min(L, k.rMr[i] + w + adj_r) : L;
    }
}

// Chase the code words from the end cell (i, j): one code read per step
// (CODE32 in int32 words, CODE16 in uint16).  The tie order of the codes
// is the oracle's (ops/poa_code.py).  Writes match targets (node id, -1 =
// insertion, -2 = untouched); returns 1 when the chase leaves the table
// (cannot happen with a correct fill).
template <int SB, typename CodeT>
__device__ int code_chase(Graph& k, const CodeT* cc, int LW, int i, int j,
                          int local) {
    using CL = CodeLayout<SB>;
    int chan = 0;                       // 0 H, 1 Hq, 2 E1, 3 E2
    while (true) {
        if (i == 0) {
            if (chan >= 2) return 1;    // E chain off the table
            if (local || j == 0) return 0;
            k.target[j - 1] = -1;       // leading insertion via row 0
            --j;
            chan = 0;
            continue;
        }
        const int cw = (int)cc[(size_t)i * LW + j];
        if (chan <= 1) {
            if (chan == 0 && !((cw >> CL::HQEQ) & 1)) {
                // F: nearest origin k < j that renewed the prefix maximum
                // of a channel that gives H here (channel 1 or 2)
                const int f1 = (cw >> CL::F1H) & 1, f2 = (cw >> CL::F2H) & 1;
                int kk = j - 1;
                for (; kk >= 0; --kk) {
                    const int ck = (int)cc[(size_t)i * LW + kk];
                    if (((f1 & (ck >> CL::F1N)) | (f2 & (ck >> CL::F2N))) & 1)
                        break;
                }
                if (kk < 0) return 1;   // no F origin: cannot happen
                for (int t = kk; t < j; ++t) k.target[t] = -1;
                j = kk;
                chan = 1;
                continue;
            }
            if (local && ((cw >> CL::HQZ) & 1)) return 0;
            const int sel = (cw >> CL::SEL) & 3;
            if (sel == 0) {
                if (j == 0) return 1;   // M at column 0: cannot happen
                k.target[j - 1] = k.rnode[i];
                i = pred_row(k, i, cw & CL::SLOT);
                --j;
                chan = 0;
                continue;
            }
            chan = 1 + sel;
        }
        const int slot = chan == 2 ? (cw >> CL::E1S) & CL::SLOT
                                   : (cw >> CL::E2S) & CL::SLOT;
        const int opened = chan == 2 ? (cw >> CL::E1O) & 1
                                     : (cw >> CL::E2O) & 1;
        i = pred_row(k, i, slot);
        if (opened) chan = 0;
    }
}

// Thread sequence `seq` (L chars) into the graph along the targets:
// guarded aligned-ring reuse or a new node, deferred ring splices (as
// poa_win.cu).  Returns 1 on overflow (node VW + 1, predecessor pcap + 1).
// STAGE is poa_code.cu's profiling knob: 3 looks at the target alone (no
// ring scan past it), 4 creates no node and books no edge (an unmatched
// position takes node 0); every other stage threads in full.
template <int STAGE = 0>
__device__ int thread_seq(Graph& k, const int8_t* seq, int L, int VW,
                          int& Vc, int& head, int& gs, int32_t* path) {
    int prev = -1, guard = -1, nspl = 0;
    for (int j = 0; j < L; ++j) {
        const int bch = seq[j];
        const int t = k.target[j];
        int v = -1;
        bool saw = false;
        if (t >= 0) {
            int cand = t;
            for (int rr = 0; rr < (STAGE == 3 ? 1 : RING_CAP); ++rr) {
                if (k.base[cand] == bch) {
                    saw = true;
                    if (k.pos[cand] > guard) { v = cand; break; }
                }
                cand = k.ring[cand];
                if (cand == t) break;
            }
        }
        if (v < 0 && STAGE == 4) {
            v = 0;
        } else if (v < 0) {
            if (saw) ++gs;
            if (Vc >= VW) return 1;
            v = Vc++;
            k.base[v] = bch; k.npred[v] = 0; k.nsucc[v] = 0;
            k.ring[v] = v;
            if (t >= 0) { k.spl[2 * nspl] = t; k.spl[2 * nspl + 1] = v; ++nspl; }
            if (prev < 0) { k.nxt[v] = head; head = v; k.pos[v] = -1; }
            else {
                k.nxt[v] = k.nxt[prev]; k.nxt[prev] = v;
                k.pos[v] = k.pos[prev];
            }
        } else {
            guard = k.pos[v];
        }
        if (prev >= 0 && STAGE != 4) {
            const int np = k.npred[v];
            bool has = false;
            for (int p = 0; p < np; ++p)
                if (k.preds[(size_t)v * k.pcap + p] == prev) { has = true; break; }
            if (!has) {
                if (np >= k.pcap) return 1;
                k.preds[(size_t)v * k.pcap + np] = prev;
                k.npred[v] = np + 1;
                k.nsucc[prev] += 1;
            }
        }
        path[j] = v;
        prev = v;
    }
    for (int s = 0; s < nspl; ++s) {
        const int t = k.spl[2 * s], v = k.spl[2 * s + 1];
        k.ring[v] = k.ring[t];
        k.ring[t] = v;
    }
    return 0;
}

// base and ring of every node, -1 past Vc (the order row is written by
// export_order)
__device__ void export_nodes_par(const Graph& k, int32_t* bexp, int VW,
                                 int Vc, int first, int stride) {
    for (int v = first; v < VW; v += stride) {
        bexp[v] = v < Vc ? k.base[v] : -1;
        bexp[VW + v] = v < Vc ? k.ring[v] : -1;
        if (v >= Vc) bexp[2 * VW + v] = -1;
    }
}

__device__ void export_order(const Graph& k, int32_t* bexp, int VW, int Vc,
                             int head) {
    int i = 0;
    for (int v = head; v >= 0 && i < Vc; v = k.nxt[v]) bexp[2 * VW + i++] = v;
}

// an overflowed block's canonical outputs
__device__ void export_overflow_par(int32_t* bpaths, size_t npaths,
                                    int32_t* bexp, int VW, int first,
                                    int stride) {
    for (size_t x = first; x < npaths; x += stride) bpaths[x] = -1;
    for (size_t x = first; x < 3 * (size_t)VW; x += stride) bexp[x] = -1;
}

}  // namespace
