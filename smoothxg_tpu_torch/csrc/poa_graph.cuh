// poa_graph.cuh — the graph side of the whole-block POA kernels
// (poa_code.cu and poa_win.cu: one thread block per POA block;
// poa_stacked.cu: one warp per POA block): the per-block graph tables, the
// seed chain, the topological walk, the rank band, the code word and its
// chase, the guarded aligned-ring threading, the export, and the launch
// geometry the kernels take from the device.  The semantics are FusedPOA's
// (+ ops/poa_host), written once for all three kernels.  Routines named
// *_par are run by every thread of a group (`first` is the thread's rank
// in the group, `stride` the group's size); the others by one thread.
//
// The tables are compact, `Tables` (node ids, positions and rows int16,
// bases and counts int8: 29 B a node at 4 predecessor slots, 45 B at 8),
// small enough for one block's shared memory at the smaller tiers.  A
// kernel carves them from its dynamic shared memory when its launch
// geometry says they fit (`Geometry::tables`), else from the block's
// device scratch; the kernels are templates on that choice, so the same
// routines compile to shared-memory or device-memory accesses.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "poa_common.cuh"

namespace {

constexpr int RING_CAP = 8;
constexpr int VW_MAX = 32766;         // VW + 1 rows must fit int16

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

// A block's graph tables: node ids, positions and rows of type Id, bases
// and counts of type Byte.  Rows are indexed by topological position (row
// 0 = the virtual source), so a fill writes its rows in order and a
// predecessor row is pos[pred] + 1.  nsucc is only ever tested against 0.
template <typename Id, typename Byte>
struct GraphT {
    Id *pos, *ring, *nxt, *preds, *rnode, *rpreds;
    Id *rlo, *rhi, *rmr, *rMr, *target, *spl;
    Byte *base, *npred, *nsucc, *rnp, *rbase;
    int pcap;
};
using Tables = GraphT<int16_t, int8_t>;

// The compact tables (LS = the launch's row stride):
//   int16  pos ring nxt                 3 * v1   (node: position, ring, list)
//          preds                        pcap * v1
//          rnode                        v1       (row: its node)
//          rpreds                       pcap * v1 (row: predecessor rows)
//          rlo rhi rmr rMr              4 * v1   (banded launches only)
//          target, ring splices         3 * LS
//   int8   base npred nsucc rnp rbase   5 * v1   (rbase: the row's base)
// padded to 16 bytes.
__host__ __device__ inline size_t table_bytes(size_t v1, int pcap, int LS,
                                              int banded) {
    const size_t w16 = (4 + 2 * (size_t)pcap + (banded ? 4 : 0)) * v1
                     + 3 * (size_t)LS;
    return (2 * w16 + 5 * v1 + 15) & ~(size_t)15;
}

// carve them out of `t` (16-byte aligned)
__device__ __forceinline__ void graph_carve(Tables& k, int8_t* t, size_t v1,
                                            int pcap, int LS, int banded) {
    int16_t* w = (int16_t*)t;
    k.pcap = pcap;
    k.pos = w;            k.ring = w + v1;       k.nxt = w + 2 * v1;
    k.preds = w + 3 * v1;
    k.rnode = k.preds + pcap * v1;
    k.rpreds = k.rnode + v1;
    int16_t* x = k.rpreds + pcap * v1;
    k.rlo = k.rhi = k.rmr = k.rMr = nullptr;
    if (banded) {
        k.rlo = x;  k.rhi = x + v1;  k.rmr = x + 2 * v1;  k.rMr = x + 3 * v1;
        x += 4 * v1;
    }
    k.target = x;
    k.spl = x + LS;
    int8_t* b = (int8_t*)(x + 3 * (size_t)LS);
    k.base = b;           k.npred = b + v1;      k.nsucc = b + 2 * v1;
    k.rnp = b + 3 * v1;   k.rbase = b + 4 * v1;
}

// predecessor row of slot s of row i (a node without predecessors reads
// row 0, the virtual source)
template <class K>
__device__ __forceinline__ int pred_row(const K& k, int i, int s) {
    return k.rnp[i] > 0 ? k.rpreds[(size_t)i * k.pcap + s] : 0;
}

// seed: sequence 0 becomes a chain of L0 nodes
template <class K>
__device__ __forceinline__ void seed_par(K& k, const int8_t* seq0, int L0,
                                         int32_t* path0, int first,
                                         int stride) {
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
template <class K>
__device__ __forceinline__ int topo_walk(K& k, int head) {
    int i = 0;
    for (int v = head; v >= 0; v = k.nxt[v]) {
        k.pos[v] = i;
        k.rnode[++i] = v;
    }
    return i;
}

// node count, base (where the layout keeps it) and predecessor rows of
// every row
template <class K>
__device__ __forceinline__ void row_preds_par(K& k, int V, int first,
                                              int stride) {
    for (int i = 1 + first; i <= V; i += stride) {
        const int v = k.rnode[i];
        const int np = k.npred[v];
        k.rnp[i] = np;
        if (k.rbase) k.rbase[i] = k.base[v];
        for (int p = 0; p < np; ++p)
            k.rpreds[(size_t)i * k.pcap + p] =
                k.pos[k.preds[(size_t)v * k.pcap + p]] + 1;
    }
}

// min/max topological rank per row (the abPOA band anchor); returns the
// longest rank D
template <class K>
__device__ __forceinline__ int band_ranks(K& k, int V) {
    int D = 0;
    for (int i = 1; i <= V; ++i) {
        const int np = k.rnp[i];
        int mr = 1, Mr = 1;
        if (np > 0) {
            int lo = 1 << 28, hi = 0;
            for (int p = 0; p < np; ++p) {
                const int u = k.rpreds[(size_t)i * k.pcap + p];
                lo = min(lo, (int)k.rmr[u]);
                hi = max(hi, (int)k.rMr[u]);
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

// the band [lo, hi] of every row of a banded launch: the adaptive band
// around the row's rank; returns the widest band's columns, hi - lo + 1
// (poa_win's window must hold it; the code-chase kernels keep rows full
// width, so no band overflows there); an unbanded fill takes [0, L]
// without reading a table
__device__ __forceinline__ int band_rows_par(Tables& k, int V, int L, int w,
                                             int D, int first, int stride) {
    const int adj_l = max(0, D - L), adj_r = max(0, L - D);
    int widest = 0;
    for (int i = 1 + first; i <= V; i += stride) {
        const int lo = max(0, k.rmr[i] - w - adj_l);
        const int hi = min(L, k.rMr[i] + w + adj_r);
        k.rlo[i] = lo;
        k.rhi[i] = hi;
        widest = max(widest, hi - lo + 1);
    }
    return widest;
}

// Where column j of a DP row sits in the row: in column order (poa_code)
// or in poa_stacked's lane-major order (SpanMap).
struct Natural {
    __device__ __forceinline__ int operator()(int j) const { return j; }
};

// poa_stacked's lane-major row order for a round of spans of S columns (a
// multiple of 4): lane l owns columns [l S, (l + 1) S), and column l S + x
// sits at (x / 4) 128 + 4 l + x % 4, so a warp's accesses to 4 columns of
// every span (an int4 of int32, or 4 uint16) are one contiguous block.
// j / S is a multiply by ceil(2^32 / S), exact while j S < 2^32.
struct SpanMap {
    unsigned S, magic;
    __device__ __forceinline__ explicit SpanMap(int s)
        : S((unsigned)s), magic(0xFFFFFFFFu / (unsigned)s + 1) {}
    __device__ __forceinline__ int operator()(int j) const {
        const unsigned l = __umulhi((unsigned)j, magic), x = j - l * S;
        return (int)((x >> 2) * 128 + l * 4 + (x & 3));
    }
};

// Chase the code words from the end cell (i, j): one code read per step
// (CODE32 in int32 words, CODE16 in uint16; rows of RS entries, column j
// at map(j)).  The tie order of the codes is the oracle's
// (ops/poa_code.py).  Writes match targets (node id, -1 = insertion, -2 =
// untouched); returns 1 when the chase leaves the table (cannot happen with
// a correct fill).
template <int SB, typename CodeT, typename Map = Natural>
__device__ __forceinline__ int code_chase(Tables& k, const CodeT* cc, int RS,
                                          int i, int j, int local,
                                          Map map = Map()) {
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
        const CodeT* row = cc + (size_t)i * RS;
        const int cw = (int)row[map(j)];
        if (chan <= 1) {
            if (chan == 0 && !((cw >> CL::HQEQ) & 1)) {
                // F: nearest origin kk < j that renewed the prefix maximum
                // of a channel that gives H here (channel 1 or 2); eight
                // code words are read at a time, so their loads overlap
                const int f1 = (cw >> CL::F1H) & 1, f2 = (cw >> CL::F2H) & 1;
                int kk = j - 1, hit = -1;
                for (; kk >= 0 && hit < 0; kk -= 8) {
                    int ck[8];
#pragma unroll
                    for (int t = 0; t < 8; ++t)
                        ck[t] = kk - t >= 0 ? (int)row[map(kk - t)] : 0;
#pragma unroll
                    for (int t = 7; t >= 0; --t)
                        if (kk - t >= 0 &&
                            (((f1 & (ck[t] >> CL::F1N))
                              | (f2 & (ck[t] >> CL::F2N))) & 1))
                            hit = kk - t;
                }
                if (hit < 0) return 1;  // no F origin: cannot happen
                for (int t = hit; t < j; ++t) k.target[t] = -1;
                j = hit;
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
template <int STAGE = 0, class K>
__device__ __forceinline__ int thread_seq(K& k, const int8_t* seq,
                                          int L, int VW, int& Vc, int& head,
                                          int& gs, int32_t* path) {
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
                k.nsucc[prev] = 1;
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
template <class K>
__device__ __forceinline__ void export_nodes_par(const K& k,
                                                 int32_t* bexp, int VW,
                                                 int Vc, int first,
                                                 int stride) {
    for (int v = first; v < VW; v += stride) {
        bexp[v] = v < Vc ? k.base[v] : -1;
        bexp[VW + v] = v < Vc ? k.ring[v] : -1;
        if (v >= Vc) bexp[2 * VW + v] = -1;
    }
}

template <class K>
__device__ __forceinline__ void export_order(const K& k, int32_t* bexp,
                                             int VW, int Vc, int head) {
    int i = 0;
    for (int v = head; v >= 0 && i < Vc; v = k.nxt[v]) bexp[2 * VW + i++] = v;
}

// an overflowed block's canonical outputs
__device__ __forceinline__ void export_overflow_par(int32_t* bpaths,
                                                    size_t npaths,
                                                    int32_t* bexp, int VW,
                                                    int first, int stride) {
    for (size_t x = first; x < npaths; x += stride) bpaths[x] = -1;
    for (size_t x = first; x < 3 * (size_t)VW; x += stride) bexp[x] = -1;
}

// ---- launch geometry, from the device (host side) ----

// How a launch lays out: `per_block` POA blocks in each of `grid` thread
// blocks, `smem` bytes of dynamic shared memory per thread block, graph
// tables in shared memory (`tables` = 1) or in device scratch (0).
struct Geometry {
    int per_block, grid, smem, tables;
};

// the current device's SM count, the shared memory one block may opt in to
// and the shared memory of one SM
inline cudaError_t device_limits(int& sms, int& smem_block, int& smem_sm) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    return err;
}

// One POA block a thread block (poa_code.cu, poa_win.cu); two thread
// blocks an SM once the batch outnumbers the SMs, else one.  The tables
// (`tb` bytes) in shared memory when they fit beside the sequence (LS
// bytes) in that share of the SM, else in device scratch; `static_smem`
// bytes stay for the kernel's static buffers.
inline cudaError_t one_block_geometry(int B, size_t tb, int LS,
                                      int static_smem, Geometry& g) {
    int sms = 0, smem_block = 0, smem_sm = 0;
    const cudaError_t err = device_limits(sms, smem_block, smem_sm);
    if (err != cudaSuccess) return err;
    const int per_sm = B > sms ? 2 : 1;
    long budget = smem_sm / per_sm - 1024;         // 1 KB per block reserved
    if (budget > smem_block) budget = smem_block;
    budget -= static_smem;
    if ((long)LS > budget) return cudaErrorInvalidValue;
    g.tables = (long)(tb + LS) <= budget;
    g.per_block = 1;
    g.grid = B;
    g.smem = (int)(LS + (g.tables ? tb : 0));
    return cudaSuccess;
}

// the geometry out of a C entry's int[4]
inline void geometry_out(const Geometry& g, int* out) {
    out[0] = g.per_block; out[1] = g.grid; out[2] = g.smem;
    out[3] = g.tables;
}

}  // namespace
