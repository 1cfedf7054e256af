// poa_stacked.cu — whole-block partial order alignment on Hopper (sm_90a),
// one warp per POA block, several POA blocks per thread block.
//
// Replaces the Pallas TPU kernel smoothxg_tpu/ops/poa_pallas_stacked.py:
// _stacked_core (wrappers _stacked_fn, _compiled_stacked), which runs K
// blocks' POA loops in lockstep in one grid step so that every vector op
// carries K blocks.  On Hopper "stacking" means several blocks in flight
// per thread block without lockstep: each warp runs one POA block's entire
// loop (seed, fill, code-chase traceback, threading) on its own, and the
// warps of a thread block finish independently.  The semantics are those
// of the numpy oracle FusedPOA, bit for bit, and of the plain PyTorch
// version smoothxg_tpu_torch/ops/poa_stacked.py:poa_stacked_reference:
// full-width rows, an optional rank band (cells outside it masked to the
// floor before the F scan), 4 predecessor slots per node (a 5th
// overflows), int32 scores with the floor NEG = -2^30.
//
// Layout: DP rows by topological position, as _stacked_core's planes
// (poa_pallas_stacked.py:14-22), so a warp writes its rows in order and a
// predecessor row is pos[pred] + 1.  Per cell H, E1, E2 as int32 (read by
// successors) and the 16-bit provenance code of poa_pallas_stacked.py:
// 433-442 (CodeLayout<2>): 14 bytes per cell, in device memory, in rows of
// the launch's row stride LS (the batch's longest sequence + 1, rounded up
// to 32 columns) rounded up to 128, rather than the caps' LW.
//
// What bounds it on this card: latency — a row is a chain of dependent
// steps (predecessor loads, the F prefix scan), and the walk, chase and
// threading are one thread's chains of dependent table reads.  The design:
//   * a row is one scan, not one per 32 columns: each lane owns a span of
//     S columns of the row's L + 1 (S a multiple of 4) and sweeps it twice.
//     Pass 1 reads the predecessor rows' H, E1, E2 for 8 columns a step as
//     int4 loads (the first predecessor's one step ahead; the M term's left
//     neighbour is the lane's previous column, or one load at the span's
//     start, so no shuffle), computes Hq, E1, E2 and the code word's slot,
//     open, SEL and HQZ fields in column order, stores E1 and E2, keeps Hq
//     and the partial code in the warp's shared row buffer and a running
//     max of the two F channels.  One two-channel exclusive warp scan of the
//     lanes' maxima (12 shuffles) gives each lane its F prefix; pass 2
//     re-reads its own columns from the row buffer and writes H and the
//     finished code word.  Only the lane's own columns cross the passes, so
//     nothing but the span's left neighbour is shared between lanes, and
//     rows are separated by __syncwarp only;
//   * every row — the planes, the row buffer, the M term's characters — is
//     stored lane-major (poa_graph.cuh:SpanMap): column x of each lane's
//     span sits beside the same column of the other lanes, so a warp's
//     loads and stores at one step are one contiguous block and its shared
//     accesses hit 32 banks.  In column order a span of 32 columns put all
//     lanes in one bank and every warp load across 32 cache lines, which
//     made one block 1.5x and a full card 6.5x slower (PERF.md, PR 5);
//   * the graph tables (poa_graph.cuh, 29 B a node) sit in shared memory
//     when K warps' tables and row buffers fit the 227 KB a block may use —
//     the main path's smaller tiers at K = 1 — so the walk, rank pass, chase
//     and threading in lane 0 step through shared memory instead of L2;
//   * K = ceil(B / SMs) warps a thread block (1 to 8), the SM count read
//     from the device, so up to one POA block per SM runs alone and larger
//     batches share SMs.  Shared memory is sized from K and the table
//     placement; a launch whose tables do not fit keeps them in device
//     scratch, one whose row buffers do not fit takes a smaller K.
//
// STAGE is _stacked_core's profiling knob (poa_pallas_stacked.py:79-84), a
// template parameter so that the stage-0 instantiation is the kernel
// itself: 0 the full kernel, 1 fill + end cell (no code chase, no
// threading), 2 fill + code chase (no threading).  A nonzero stage is for
// timing: its graphs are invalid by design.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
//        -fPIC, one process per source, then one link into a shared
//        library (smoothxg_tpu_torch/ops/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "poa_common.cuh"
#include "poa_graph.cuh"
#include "smem.cuh"

namespace {

using CL = CodeLayout<2>;
constexpr int PCAP_STK = 4;
constexpr int KMAX = 8;              // warps (POA blocks) per thread block
constexpr int G = 8;                 // columns of a lane's step: 2 int4 a plane

// max value, ties to the smaller row; the result lands in every lane
__device__ __forceinline__ void warp_best(int& v, int& r) {
    for (int o = 16; o; o >>= 1) {
        const int ov = __shfl_xor_sync(FULL, v, o);
        const int orr = __shfl_xor_sync(FULL, r, o);
        if (ov > v || (ov == v && orr < r)) { v = ov; r = orr; }
    }
}

__device__ __forceinline__ int part(const int4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// a lane's 8 columns of one predecessor row at `rb` (their lane-major
// position): H, E1, E2 as two int4 each, the second only when the step has
// 8 columns (`two`), else the floor
__device__ __forceinline__ void load_step(const int32_t* rb, size_t plane,
                                          bool two, int4 (&v)[3][2]) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
        const int32_t* r = rb + t * plane;
        v[t][0] = *(const int4*)r;
        v[t][1] = two ? *(const int4*)(r + 128)
                      : make_int4(NEG, NEG, NEG, NEG);
    }
}

// the planes' row stride: LS rounded up so that 32 lane spans of a
// multiple of 4 columns (SpanMap) fit any round of the launch
__host__ __device__ inline int span_stride(int LS) {
    return (LS + 127) & ~127;
}

// shared bytes of one warp besides its tables: the row buffers of Hq
// (int32) and partial codes (uint16) and the M term's characters, all
// lane-major, a span stride each; the round's sequence (LS)
__host__ __device__ inline size_t warp_row_bytes(int LS) {
    return 7 * (size_t)span_stride(LS) + (size_t)LS;
}

// device scratch of one POA block: the graph tables (used when they stay
// in device memory), then the int32 planes H E1 E2 and the uint16 code
// plane, each (VW + 1) x span_stride(LS), rows in SpanMap order —
// mirrored by ops/poa_stacked.py:scratch_words
__host__ __device__ inline size_t block_bytes(size_t v1, int pcap, int LS,
                                              int banded) {
    return table_bytes(v1, pcap, LS, banded)
         + 14 * v1 * (size_t)span_stride(LS);
}

template <int STAGE, bool SMEM_TABLES>
__global__ void __launch_bounds__(KMAX * 32, 1)
poa_stacked_kernel(const int8_t* __restrict__ seqs,
                   const int32_t* __restrict__ slen,
                   const int32_t* __restrict__ nseq,
                   const int32_t* __restrict__ params, int32_t* meta,
                   int32_t* exp_, int32_t* paths, int8_t* scratch, int B,
                   int RW, int LW, int VW, int pcap, int LS, int local,
                   int banded) {
    extern __shared__ int4 s_dyn[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;                      // whole warps only

    const size_t v1 = (size_t)VW + 1;
    const int RS = span_stride(LS);
    const size_t tb = table_bytes(v1, pcap, LS, banded);
    const size_t plane = v1 * (size_t)RS;
    int8_t* sw = (int8_t*)s_dyn
               + (size_t)warp * ((SMEM_TABLES ? tb : 0) + warp_row_bytes(LS));
    int8_t* sc = scratch + (size_t)b * block_bytes(v1, pcap, LS, banded);
    Tables k;
    graph_carve(k, SMEM_TABLES ? sw : sc, v1, pcap, LS, banded);
    int8_t* rows = sw + (SMEM_TABLES ? tb : 0);
    int32_t* s_hq = (int32_t*)rows;
    uint16_t* s_cw = (uint16_t*)(rows + 4 * (size_t)RS);
    int8_t* s_sq = rows + 6 * (size_t)RS;
    int8_t* s_seq = rows + 7 * (size_t)RS;
    int32_t* H = (int32_t*)(sc + tb);
    int32_t* E1 = H + plane;
    int32_t* E2 = E1 + plane;
    uint16_t* CC = (uint16_t*)(E2 + plane);

    const int R = nseq[b];
    const int32_t* lens = slen + (size_t)b * RW;
    const int32_t* pp = params + (size_t)b * 8;
    const int m = pp[0], n = pp[1], g = pp[2], e = pp[3], q = pp[4],
              c = pp[5], wb = pp[6], wfm = pp[7];
    const int8_t* bseqs = seqs + (size_t)b * RW * LW;
    int32_t* bpaths = paths + (size_t)b * RW * LW;
    int32_t* bexp = exp_ + (size_t)b * 3 * VW;

    for (size_t x = lane; x < (size_t)RW * LW; x += 32) bpaths[x] = -1;

    // ---- capacity check (every lane computes the same verdict; LS is
    // above every length that fits LW, see poa_stacked_launch) ----
    int ovf = (R < 1 || R > RW);
    int L0 = 0;
    if (!ovf) {
        L0 = lens[0];
        int maxL = 0;
        for (int r = 0; r < R; ++r) maxL = max(maxL, lens[r]);
        ovf = L0 < 1 || L0 > VW || maxL > LW - 1 || maxL > LS - 1;
    }
    // graph state, authoritative in lane 0
    int Vc = L0, head = 0, gs = 0;
    __syncwarp();
    if (!ovf) seed_par(k, bseqs, L0, bpaths, lane, 32);
    __syncwarp();

    for (int r = 1; r < R && !ovf; ++r) {
        const int L = lens[r];
        if (L == 0) continue;
        for (int j = lane; j < L; j += 32) {
            s_seq[j] = bseqs[(size_t)r * LW + j];
            k.target[j] = -2;
        }
        int V = 0;
        if (lane == 0) V = topo_walk(k, head);
        __syncwarp();
        V = __shfl_sync(FULL, V, 0);
        row_preds_par(k, V, lane, 32);
        // this round's spans: lane `lane` owns columns [jl, jl + S) of
        // every row (those below L + 1), in SpanMap order
        const int nc = L + 1;
        const int S = (((nc + 31) >> 5) + 3) & ~3;
        const SpanMap map(S);
        const int jl = lane * S;
        // row 0 (the virtual source) in this round's order, and the M
        // term's character of each column, lane-major
        for (int x = 0; x < S; ++x) {
            const int j = jl + x;
            const int o = (x >> 2) * 128 + lane * 4 + (x & 3);
            H[o] = (local || j == 0) ? 0
                 : max(-(g + (j - 1) * e), -(q + (j - 1) * c));
            E1[o] = NEG; E2[o] = NEG; CC[o] = 0;
            s_sq[x * 32 + lane] = j >= 1 && j <= L ? s_seq[j - 1] : 0;
        }
        __syncwarp();
        if (banded) {
            int D = 0;
            if (lane == 0) D = band_ranks(k, V);
            __syncwarp();
            D = __shfl_sync(FULL, D, 0);
            band_rows_par(k, V, L, wb + (wfm * L) / 1000, D, lane, 32);
            __syncwarp();
        }

        // ---- DP fill, one row per topological position, 8 columns of
        // the lane's span a step (2 int4 of each plane, every access of
        // the warp one contiguous block) ----
        int tbest = INT_MIN, trow = 0;        // local end cell, per lane
        for (int i = 1; i <= V; ++i) {
            const int np = k.rnp[i];
            const int npr = np > 0 ? np : 1;
            const int bv = k.rbase[i];
            const int blo = banded ? k.rlo[i] : 0;
            const int bhi = banded ? k.rhi[i] : L;
            int pr[PCAP_STK];                 // predecessor rows
#pragma unroll
            for (int p = 0; p < PCAP_STK; ++p)
                pr[p] = p < np ? k.rpreds[(size_t)i * pcap + p] : 0;
            int32_t* Hi = H + (size_t)i * RS;
            int32_t* E1i = E1 + (size_t)i * RS;
            int32_t* E2i = E2 + (size_t)i * RS;
            uint16_t* Ci = CC + (size_t)i * RS;

            // pass 1: Hq, E1, E2 and the partial code, column by column
            int t1 = INT_MIN, t2 = INT_MIN;   // span max of hq + ext * j
            int hl = NEG, sl = 0;             // pred max of H at column j - 1
            if (lane > 0 && jl < nc) {        // the left lane's last column
                const int o = ((S - 1) >> 2) * 128 + (lane - 1) * 4 + 3;
#pragma unroll
                for (int p = 0; p < PCAP_STK; ++p) {
                    if (p < npr) {
                        const int h = H[(size_t)pr[p] * RS + o];
                        if (p == 0 || h > hl) { hl = h; sl = p; }
                    }
                }
            }
            // slot 0's H, E1, E2 for a step, loaded one step ahead so
            // that they arrive while the step before computes
            int4 n0[3][2];
            const int32_t* r0 = H + (size_t)pr[0] * RS + lane * 4;
            load_step(r0, plane, 4 < S, n0);
            for (int x0 = 0; x0 < S; x0 += G) {
                const bool two = x0 + 4 < S;  // the step's second 4 columns
                const int o0 = (x0 >> 2) * 128 + lane * 4;
                int4 v0[3][2];
#pragma unroll
                for (int t = 0; t < 3; ++t) {
                    v0[t][0] = n0[t][0];
                    v0[t][1] = n0[t][1];
                }
                if (x0 + G < S)
                    load_step(r0 + ((x0 + G) >> 2) * 128, plane,
                              x0 + G + 4 < S, n0);
                // predecessor maxima of the step's columns and the first
                // slot holding each (2 bits a column)
                int hm[G], x1[G], x2[G];
                unsigned hs = 0, s1 = 0, s2 = 0;
#pragma unroll
                for (int p = 0; p < PCAP_STK; ++p) {
                    if (p >= npr) break;
                    int4 vp[3][2];
                    if (p == 0) {
#pragma unroll
                        for (int t = 0; t < 3; ++t) {
                            vp[t][0] = v0[t][0];
                            vp[t][1] = v0[t][1];
                        }
                    } else {
                        load_step(H + (size_t)pr[p] * RS + o0, plane, two,
                                  vp);
                    }
                    const int4* va = vp[0];
                    const int4* vb = vp[1];
                    const int4* vc = vp[2];
#pragma unroll
                    for (int x = 0; x < G; ++x) {
                        const int h = part(va[x >> 2], x & 3);
                        const int y1 = part(vb[x >> 2], x & 3);
                        const int y2 = part(vc[x >> 2], x & 3);
                        const unsigned clr = ~(3u << (2 * x)),
                                       set = (unsigned)p << (2 * x);
                        if (p == 0) {
                            hm[x] = h; x1[x] = y1; x2[x] = y2;
                            continue;
                        }
                        if (h > hm[x]) { hm[x] = h; hs = (hs & clr) | set; }
                        if (y1 > x1[x]) { x1[x] = y1; s1 = (s1 & clr) | set; }
                        if (y2 > x2[x]) { x2[x] = y2; s2 = (s2 & clr) | set; }
                    }
                }
#pragma unroll
                for (int x = 0; x < G; ++x) {
                    const int xx = x0 + x, j = jl + xx;
                    const int hsx = (hs >> (2 * x)) & 3;
                    int e1 = NEG, e2 = NEG;
                    if (xx < S && j < nc) {
                        const int M = j == 0 ? NEG
                            : hl + ((int)s_sq[xx * 32 + lane] == bv ? m : -n);
                        const int o1 = hm[x] - g, x1e = x1[x] - e;
                        const int o2 = hm[x] - q, x2e = x2[x] - c;
                        const int op1 = o1 >= x1e, op2 = o2 >= x2e;
                        e1 = max(max(o1, x1e), NEG);
                        e2 = max(max(o2, x2e), NEG);
                        int hq = max(M, max(e1, e2));
                        int cw = (j == 0 ? 0 : sl)
                            | ((op1 ? hsx : (int)(s1 >> (2 * x)) & 3)
                               << CL::E1S)
                            | (op1 << CL::E1O)
                            | ((op2 ? hsx : (int)(s2 >> (2 * x)) & 3)
                               << CL::E2S)
                            | (op2 << CL::E2O);
                        if (local) {
                            hq = max(hq, 0);
                            cw |= (hq == 0) << CL::HQZ;
                        }
                        cw |= (M == hq ? 0 : (e1 == hq ? 1 : 2)) << CL::SEL;
                        if (j < blo || j > bhi) { hq = NEG; e1 = NEG; e2 = NEG; }
                        s_hq[xx * 32 + lane] = hq;
                        s_cw[xx * 32 + lane] = (uint16_t)cw;
                        t1 = max(t1, hq + e * j);
                        t2 = max(t2, hq + c * j);
                        hl = hm[x];
                        sl = hsx;
                    }
                    x1[x] = e1;
                    x2[x] = e2;
                }
#pragma unroll
                for (int u = 0; u < G / 4; ++u) {
                    if (u == 1 && !two) break;
                    *(int4*)(E1i + o0 + 128 * u) = make_int4(
                        x1[4 * u], x1[4 * u + 1], x1[4 * u + 2], x1[4 * u + 3]);
                    *(int4*)(E2i + o0 + 128 * u) = make_int4(
                        x2[4 * u], x2[4 * u + 1], x2[4 * u + 2], x2[4 * u + 3]);
                }
            }

            // the F channels' exclusive prefix max over the lanes' spans
            int i1 = t1, i2 = t2;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y1 = __shfl_up_sync(FULL, i1, o);
                const int y2 = __shfl_up_sync(FULL, i2, o);
                if (lane >= o) { i1 = max(i1, y1); i2 = max(i2, y2); }
            }
            int g1 = __shfl_up_sync(FULL, i1, 1);
            int g2 = __shfl_up_sync(FULL, i2, 1);
            if (lane == 0) { g1 = INT_MIN; g2 = INT_MIN; }
            g1 = max(g1, NEG);
            g2 = max(g2, NEG);

            // pass 2: H and the finished code word
            int rowbest = INT_MIN;
            for (int x0 = 0; x0 < S; x0 += G) {
                const bool two = x0 + 4 < S;
                const int o0 = (x0 >> 2) * 128 + lane * 4;
                int hv[G];
                unsigned cv[G];
#pragma unroll
                for (int x = 0; x < G; ++x) {
                    const int xx = x0 + x, j = jl + xx;
                    hv[x] = NEG;
                    cv[x] = 0;
                    if (xx < S && j < nc) {
                        const int hq = s_hq[xx * 32 + lane];
                        int f1 = NEG, f2 = NEG;
                        if (j > 0) {
                            f1 = g1 - g - e * (j - 1);
                            f2 = g2 - q - c * (j - 1);
                        }
                        int h = max(hq, max(f1, f2));
                        const int u1 = hq + e * j, u2 = hq + c * j;
                        const int n1 = u1 >= g1, n2 = u2 >= g2;
                        g1 = max(g1, u1);
                        g2 = max(g2, u2);
                        if (j < blo || j > bhi) h = NEG;
                        else rowbest = max(rowbest, h);
                        hv[x] = h;
                        cv[x] = s_cw[xx * 32 + lane] | ((hq == h) << CL::HQEQ)
                              | ((f1 == h) << CL::F1H)
                              | ((f2 == h) << CL::F2H)
                              | (n1 << CL::F1N) | (n2 << CL::F2N);
                    }
                }
#pragma unroll
                for (int u = 0; u < G / 4; ++u) {
                    if (u == 1 && !two) break;
                    *(int4*)(Hi + o0 + 128 * u) = make_int4(
                        hv[4 * u], hv[4 * u + 1], hv[4 * u + 2], hv[4 * u + 3]);
                    *(uint2*)(Ci + o0 + 128 * u) = make_uint2(
                        cv[4 * u] | cv[4 * u + 1] << 16,
                        cv[4 * u + 2] | cv[4 * u + 3] << 16);
                }
            }
            if (rowbest > tbest) { tbest = rowbest; trow = i; }
            __syncwarp();
        }

        // ---- end cell ----
        int ei = 0, ej = L, have = 1;
        if (local) {
            warp_best(tbest, trow);
            have = tbest > 0;
            ei = trow;
            if (have) {                       // first column holding it
                const int32_t* row = H + (size_t)ei * RS;
                int first = INT_MAX;
                for (int x = S - 1; x >= 0; --x) {
                    const int j = jl + x;
                    if (j < nc &&
                        row[(x >> 2) * 128 + lane * 4 + (x & 3)] == tbest)
                        first = j;
                }
                for (int o = 16; o; o >>= 1)
                    first = min(first, __shfl_xor_sync(FULL, first, o));
                ej = first;
            }
        } else {
            int hb = NEG - 1, hr = INT_MAX;
            const int oL = map(L);
            for (int i = 1 + lane; i <= V; i += 32) {
                if (k.nsucc[k.rnode[i]] != 0) continue;
                const int h = H[(size_t)i * RS + oL];
                if (h > hb) { hb = h; hr = i; }
            }
            warp_best(hb, hr);
            ei = hr == INT_MAX ? 0 : hr;      // (a DAG always has a sink)
        }

        // ---- code chase, then threading (lane 0); stage 1 stops at the
        // end cell, stage 2 after the chase ----
        if (lane == 0 && STAGE != 1) {
            int o = have ? code_chase<2>(k, CC, RS, ei, ej, local, map) : 0;
            if (!o && STAGE != 2)
                o = thread_seq(k, s_seq, L, VW, Vc, head, gs,
                               bpaths + (size_t)r * LW);
            ovf = o;
        }
        __syncwarp();
        ovf = __shfl_sync(FULL, ovf, 0);
    }

    // ---- export ----
    if (ovf) {
        export_overflow_par(bpaths, (size_t)RW * LW, bexp, VW, lane, 32);
        if (lane == 0) {
            meta[4 * b] = 0; meta[4 * b + 1] = 1;
            meta[4 * b + 2] = R; meta[4 * b + 3] = 0;
        }
        return;
    }
    Vc = __shfl_sync(FULL, Vc, 0);
    export_nodes_par(k, bexp, VW, Vc, lane, 32);
    if (lane == 0) {
        export_order(k, bexp, VW, Vc, head);
        meta[4 * b] = Vc; meta[4 * b + 1] = 0;
        meta[4 * b + 2] = R; meta[4 * b + 3] = gs;
    }
}

// K = ceil(B / SMs) warps a thread block, clamped to [1, KMAX]; the
// tables in shared memory when K warps' tables and row buffers fit the
// block's opt-in limit, else in device scratch with K cut to what the row
// buffers allow.  Decided before the launch, from the device's limits.
inline cudaError_t stacked_geometry(int B, int VW, int pcap, int LS,
                                    int banded, Geometry& g) {
    int sms = 0, smem_block = 0, smem_sm = 0;
    const cudaError_t err = device_limits(sms, smem_block, smem_sm);
    if (err != cudaSuccess) return err;
    const size_t tb = table_bytes((size_t)VW + 1, pcap, LS, banded);
    const size_t row = warp_row_bytes(LS);
    size_t K = (size_t)((B + sms - 1) / sms);
    K = K < 1 ? 1 : K > (size_t)KMAX ? (size_t)KMAX : K;
    g.tables = K * (tb + row) <= (size_t)smem_block;
    if (!g.tables && K * row > (size_t)smem_block)
        K = (size_t)smem_block / row;
    if (K < 1) return cudaErrorInvalidValue;    // one row buffer too large
    g.per_block = (int)K;
    g.grid = (int)((B + K - 1) / K);
    g.smem = (int)(K * ((g.tables ? tb : 0) + row));
    return cudaSuccess;
}

constexpr int STAGES = 3;

template <int S, bool T>
cudaError_t launch_stage(const Geometry& geo, const void* seqs,
                         const void* slen, const void* nseq,
                         const void* params, void* meta, void* exp_,
                         void* paths, void* scratch, int B, int RW, int LW,
                         int VW, int pcap, int LS, int local, int banded,
                         cudaStream_t stream) {
    const cudaError_t err = opt_in_smem(poa_stacked_kernel<S, T>, geo.smem);
    if (err != cudaSuccess) return err;
    poa_stacked_kernel<S, T><<<geo.grid, geo.per_block * 32, geo.smem,
                               stream>>>(
        (const int8_t*)seqs, (const int32_t*)slen, (const int32_t*)nseq,
        (const int32_t*)params, (int32_t*)meta, (int32_t*)exp_,
        (int32_t*)paths, (int8_t*)scratch, B, RW, LW, VW, pcap, LS, local,
        banded);
    return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Geometry&, const void*, const void*,
                                 const void*, const void*, void*, void*,
                                 void*, void*, int, int, int, int, int, int,
                                 int, int, cudaStream_t);
constexpr LaunchFn STAGE_LAUNCH[STAGES][2] = {
    {launch_stage<0, false>, launch_stage<0, true>},
    {launch_stage<1, false>, launch_stage<1, true>},
    {launch_stage<2, false>, launch_stage<2, true>}};

inline bool bad_shape(int VW, int pcap, int LS) {
    return pcap < 1 || pcap > PCAP_STK || VW < 1 || VW > VW_MAX ||
           LS < 32 || LS % 32 != 0;
}

}  // namespace

extern "C" {

// The launch geometry of `B` POA blocks at these capacities and row
// stride on the current device: out = (warps per thread block K, grid,
// dynamic shared bytes, tables in shared memory).  Returns a CUDA error.
int poa_stacked_geometry(int B, int VW, int pcap, int LS, int banded,
                         int* out) {
    if (B <= 0 || bad_shape(VW, pcap, LS)) return (int)cudaErrorInvalidValue;
    Geometry g;
    const cudaError_t err = stacked_geometry(B, VW, pcap, LS, banded, g);
    if (err == cudaSuccess) geometry_out(g, out);
    return (int)err;
}

// Launch stage `stage` (0 = the kernel; 1, 2 the profiling cuts above) on
// `stream` (PyTorch's current stream) in the geometry above, with DP rows
// of LS columns (a multiple of 32 above every sequence length that fits
// LW, ops/poa_win.py:row_stride) and `scratch` holding B blocks of
// block_bytes.  Returns cudaGetLastError() after the launch: nonzero means
// the launch was refused or an earlier asynchronous fault is pending, and
// the caller raises.
int poa_stacked_launch(const void* seqs, const void* slen, const void* nseq,
                       const void* params, void* meta, void* exp_,
                       void* paths, void* scratch, int B, int RW, int LW,
                       int VW, int pcap, int stage, int LS, int local,
                       int banded, void* stream) {
    if (B <= 0) return 0;
    if (bad_shape(VW, pcap, LS) || stage < 0 || stage >= STAGES)
        return (int)cudaErrorInvalidValue;
    Geometry geo;
    const cudaError_t err = stacked_geometry(B, VW, pcap, LS, banded, geo);
    if (err != cudaSuccess) return (int)err;
    return (int)STAGE_LAUNCH[stage][geo.tables](
        geo, seqs, slen, nseq, params, meta, exp_, paths, scratch, B, RW, LW,
        VW, pcap, LS, local, banded, (cudaStream_t)stream);
}

}  // extern "C"
