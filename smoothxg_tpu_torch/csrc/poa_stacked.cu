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
// 433-442 (CodeLayout<2>): 14 bytes per cell, in device memory.
//
// What bounds it on this card: latency.  A warp fills a row in 32-column
// chunks, one column per lane: the predecessor maxima are per-lane loads,
// issued for 8 chunks at a time so that their L2 round trips overlap; the
// M term's left neighbour and the F channels' prefix maxima are warp
// shuffles, the prefix maxima carry from chunk to chunk in registers, and
// rows are separated by __syncwarp only — there is no __syncthreads in the
// kernel.  The walk, rank pass, code chase and threading run in lane 0.
// Against poa_code.cu (one thread block per POA block, a barrier per row)
// this kernel trades the 256-thread row for a 32-lane one: it measures what
// the per-row barriers cost.  A launch takes K = ceil(B / 132) warps per
// thread block (1 to 8), so up to 132 blocks each get an SM of their own
// and larger batches share them.
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

namespace {

using CL = CodeLayout<2>;
constexpr int PCAP_STK = 4;
constexpr int KMAX = 8;              // warps (POA blocks) per thread block
constexpr int SUB = 8;               // 32-column chunks per load batch
constexpr int SMS = 132;

// max value, ties to the smaller row; the result lands in every lane
__device__ __forceinline__ void warp_best(int& v, int& r) {
    for (int o = 16; o; o >>= 1) {
        const int ov = __shfl_xor_sync(FULL, v, o);
        const int orr = __shfl_xor_sync(FULL, r, o);
        if (ov > v || (ov == v && orr < r)) { v = ov; r = orr; }
    }
}

// Per-block scratch: the graph tables (poa_graph.cuh), then the int32
// planes H E1 E2, each (VW + 1) x LW, then the uint16 code plane —
// mirrored by scratch_words in ops/poa_stacked.py.
template <int STAGE>
__global__ void __launch_bounds__(KMAX * 32)
poa_stacked_kernel(const int8_t* __restrict__ seqs,
                   const int32_t* __restrict__ slen,
                   const int32_t* __restrict__ nseq,
                   const int32_t* __restrict__ params, int32_t* meta,
                   int32_t* exp_, int32_t* paths, int32_t* scratch, int B,
                   int RW, int LW, int VW, int pcap, int local, int banded) {
    extern __shared__ int8_t s_seqs[];       // each warp's round sequence
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;                      // whole warps only
    int8_t* s_seq = s_seqs + (size_t)warp * (((size_t)LW + 15) & ~(size_t)15);

    const size_t v1 = (size_t)VW + 1;
    const size_t plane = v1 * (size_t)LW;
    int32_t* sc = scratch + (size_t)b * (graph_words(v1, pcap, LW)
                                         + 3 * plane + (plane + 1) / 2);
    Graph k;
    int32_t* H = graph_carve(k, sc, v1, pcap, LW);
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

    // ---- capacity check (every lane computes the same verdict) ----
    int ovf = (R < 1 || R > RW);
    int L0 = 0;
    if (!ovf) {
        L0 = lens[0];
        int maxL = 0;
        for (int r = 0; r < R; ++r) maxL = max(maxL, lens[r]);
        ovf = L0 < 1 || L0 > VW || maxL > LW - 1;
    }
    // graph state, authoritative in lane 0
    int Vc = L0, head = 0, gs = 0;
    __syncwarp();
    if (!ovf) {
        for (int j = lane; j < LW; j += 32) {          // row 0: the source
            H[j] = (local || j == 0) ? 0
                 : max(-(g + (j - 1) * e), -(q + (j - 1) * c));
            E1[j] = NEG; E2[j] = NEG; CC[j] = 0;
        }
        seed_par(k, bseqs, L0, bpaths, lane, 32);
    }
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
        __syncwarp();
        int D = 0;
        if (banded && lane == 0) D = band_ranks(k, V);
        __syncwarp();
        D = __shfl_sync(FULL, D, 0);
        band_rows_par(k, V, L, banded, wb + (wfm * L) / 1000, D, lane, 32);
        __syncwarp();

        // ---- DP fill, one row per topological position, 32 columns a
        // chunk, one per lane ----
        int tbest = INT_MIN, trow = 0;        // local end cell, per lane
        for (int i = 1; i <= V; ++i) {
            const int v = k.rnode[i];
            const int np = k.rnp[i];
            const int bv = k.base[v];
            const int blo = k.rlo[i], bhi = k.rhi[i];
            int prow[PCAP_STK];
            const int npr = np > 0 ? np : 1;
            for (int p = 0; p < npr; ++p) prow[p] = pred_row(k, i, p);
            int carry1 = NEG, carry2 = NEG;   // F prefix maxima so far
            int hcar = NEG, scar = 0;         // pred max H, slot at c0 - 1
            int rowbest = INT_MIN;
            int32_t* Hi = H + (size_t)i * LW;
            int32_t* E1i = E1 + (size_t)i * LW;
            int32_t* E2i = E2 + (size_t)i * LW;
            uint16_t* Ci = CC + (size_t)i * LW;
            for (int c0 = 0; c0 <= L; c0 += 32 * SUB) {
                // predecessor maxima of the next SUB chunks and the first
                // slot holding each: each lane issues its loads for all of
                // them before the chunks are computed in order
                int hm[SUB], hs[SUB], x1[SUB], s1[SUB], x2[SUB], s2[SUB];
#pragma unroll
                for (int u = 0; u < SUB; ++u) {
                    hm[u] = NEG; x1[u] = NEG; x2[u] = NEG;
                    hs[u] = 0; s1[u] = 0; s2[u] = 0;
                }
                for (int p = 0; p < npr; ++p) {
                    const int32_t* rb = H + (size_t)prow[p] * LW;
#pragma unroll
                    for (int u = 0; u < SUB; ++u) {
                        const int j = c0 + 32 * u + lane;
                        if (j > L) continue;
                        const int h = rb[j], a = rb[plane + j],
                                  d = rb[2 * plane + j];
                        if (p == 0 || h > hm[u]) { hm[u] = h; hs[u] = p; }
                        if (p == 0 || a > x1[u]) { x1[u] = a; s1[u] = p; }
                        if (p == 0 || d > x2[u]) { x2[u] = d; s2[u] = p; }
                    }
                }
#pragma unroll
                for (int u = 0; u < SUB; ++u) {
                    if (c0 + 32 * u > L) break;     // uniform over the warp
                    const int j = c0 + 32 * u + lane;
                    const bool act = j <= L;
                    // column j - 1: the left lane's maxima, or the last
                    // chunk's
                    int hl = __shfl_up_sync(FULL, hm[u], 1);
                    int sl = __shfl_up_sync(FULL, hs[u], 1);
                    if (lane == 0) { hl = hcar; sl = scar; }
                    hcar = __shfl_sync(FULL, hm[u], 31);
                    scar = __shfl_sync(FULL, hs[u], 31);
                    int hq = NEG, cw = 0, e1 = NEG, e2 = NEG;
                    if (act) {
                        const int M = j == 0 ? NEG
                            : hl + ((int)s_seq[j - 1] == bv ? m : -n);
                        const int o1 = hm[u] - g, x1e = x1[u] - e;
                        const int o2 = hm[u] - q, x2e = x2[u] - c;
                        const int op1 = o1 >= x1e, op2 = o2 >= x2e;
                        e1 = max(max(o1, x1e), NEG);
                        e2 = max(max(o2, x2e), NEG);
                        hq = max(M, max(e1, e2));
                        cw = (j == 0 ? 0 : sl)
                           | ((op1 ? hs[u] : s1[u]) << CL::E1S)
                           | (op1 << CL::E1O)
                           | ((op2 ? hs[u] : s2[u]) << CL::E2S)
                           | (op2 << CL::E2O);
                        if (local) {
                            hq = max(hq, 0);
                            cw |= (hq == 0) << CL::HQZ;
                        }
                        cw |= (M == hq ? 0 : (e1 == hq ? 1 : 2)) << CL::SEL;
                        if (j < blo || j > bhi) { hq = NEG; e1 = NEG; e2 = NEG; }
                    }
                    // exclusive prefix max over the row of hq + ext * j
                    const int u1 = act ? hq + e * j : INT_MIN;
                    const int u2 = act ? hq + c * j : INT_MIN;
                    int i1 = u1, i2 = u2;
                    for (int o = 1; o < 32; o <<= 1) {
                        const int y1 = __shfl_up_sync(FULL, i1, o);
                        const int y2 = __shfl_up_sync(FULL, i2, o);
                        if (lane >= o) { i1 = max(i1, y1); i2 = max(i2, y2); }
                    }
                    int g1 = __shfl_up_sync(FULL, i1, 1);
                    int g2 = __shfl_up_sync(FULL, i2, 1);
                    if (lane == 0) { g1 = INT_MIN; g2 = INT_MIN; }
                    g1 = max(g1, carry1);
                    g2 = max(g2, carry2);
                    carry1 = max(carry1, __shfl_sync(FULL, i1, 31));
                    carry2 = max(carry2, __shfl_sync(FULL, i2, 31));
                    if (act) {
                        int f1 = NEG, f2 = NEG;
                        if (j > 0) {
                            f1 = g1 - g - e * (j - 1);
                            f2 = g2 - q - c * (j - 1);
                        }
                        int h = max(hq, max(f1, f2));
                        if (j < blo || j > bhi) h = NEG;
                        else rowbest = max(rowbest, h);
                        cw |= ((hq == h) << CL::HQEQ)
                            | ((f1 == h) << CL::F1H) | ((f2 == h) << CL::F2H)
                            | ((u1 >= g1) << CL::F1N)
                            | ((u2 >= g2) << CL::F2N);
                        Hi[j] = h; E1i[j] = e1; E2i[j] = e2;
                        Ci[j] = (uint16_t)cw;
                    }
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
                const int32_t* row = H + (size_t)ei * LW;
                for (int c0 = 0; c0 <= L; c0 += 32) {
                    const int j = c0 + lane;
                    const unsigned hit =
                        __ballot_sync(FULL, j <= L && row[j] == tbest);
                    if (hit) { ej = c0 + __ffs(hit) - 1; break; }
                }
            }
        } else {
            int hb = NEG - 1, hr = INT_MAX;
            for (int i = 1 + lane; i <= V; i += 32) {
                if (k.nsucc[k.rnode[i]] != 0) continue;
                const int h = H[(size_t)i * LW + L];
                if (h > hb) { hb = h; hr = i; }
            }
            warp_best(hb, hr);
            ei = hr == INT_MAX ? 0 : hr;      // (a DAG always has a sink)
        }

        // ---- code chase, then threading (lane 0); stage 1 stops at the
        // end cell, stage 2 after the chase ----
        if (lane == 0 && STAGE != 1) {
            int o = have ? code_chase<2>(k, CC, LW, ei, ej, local) : 0;
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

constexpr int STAGES = 3;

template <int S>
int launch_stage(const void* seqs, const void* slen, const void* nseq,
                 const void* params, void* meta, void* exp_, void* paths,
                 void* scratch, int B, int RW, int LW, int VW, int pcap,
                 int local, int banded, cudaStream_t stream) {
    const int K = min(KMAX, max(1, (B + SMS - 1) / SMS));
    const size_t smem = (size_t)K * (((size_t)LW + 15) & ~(size_t)15);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            poa_stacked_kernel<S>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    poa_stacked_kernel<S><<<(B + K - 1) / K, K * 32, smem, stream>>>(
        (const int8_t*)seqs, (const int32_t*)slen, (const int32_t*)nseq,
        (const int32_t*)params, (int32_t*)meta, (int32_t*)exp_,
        (int32_t*)paths, (int32_t*)scratch, B, RW, LW, VW, pcap, local,
        banded);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch stage `stage` (0 = the kernel; 1, 2 the profiling cuts above) on
// `stream` (PyTorch's current stream): ceil(B / K) thread blocks of K
// warps, K = ceil(B / 132) clamped to [1, 8].  Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused or an earlier
// asynchronous fault is pending, and the caller raises.
int poa_stacked_launch(const void* seqs, const void* slen, const void* nseq,
                       const void* params, void* meta, void* exp_,
                       void* paths, void* scratch, int B, int RW, int LW,
                       int VW, int pcap, int stage, int local, int banded,
                       void* stream) {
    if (B <= 0) return 0;
    if (pcap < 1 || pcap > PCAP_STK || stage < 0 || stage >= STAGES)
        return (int)cudaErrorInvalidValue;
    auto* fn = stage == 0 ? launch_stage<0>
             : stage == 1 ? launch_stage<1> : launch_stage<2>;
    return fn(seqs, slen, nseq, params, meta, exp_, paths, scratch, B, RW,
              LW, VW, pcap, local, banded, (cudaStream_t)stream);
}

}  // extern "C"
