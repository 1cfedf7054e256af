// poa_code.cu — whole-block partial order alignment on Hopper (sm_90a),
// code-chase traceback, 8 predecessor slots.
//
// Replaces the Pallas TPU kernel smoothxg_tpu/ops/poa_pallas_fused.py:
// _pallas_core (wrappers _fused_fn, _compiled_fused): one thread block runs
// one POA block's entire loop — seed a chain from sequence 0, then for each
// later sequence fill the sequence-vs-DAG DP in topological order, trace it
// back and thread the sequence into the graph.  The semantics are those of
// the numpy oracle FusedPOA (+ ops/poa_host), bit for bit, and of the plain
// PyTorch version smoothxg_tpu_torch/ops/poa_code.py:poa_code_reference,
// which is written against this file.
//
// What differs from poa_win.cu (the port of the windowed kernel): rows are
// full width (a banded row masks the cells outside its band to the floor
// before the F scan instead of storing a window), and the traceback is a
// code chase.  During the fill every cell records one int32 provenance
// word (fields of poa_pallas_fused.py:403-409, CodeLayout<7>): the first
// predecessor slot holding the maximum for M, E1 and E2, open/extend bits,
// the Hq selector, the H-equals bits and the F prefix-renewal bits.  The
// traceback then reads one word per step instead of re-reading H and E
// of every predecessor slot.  The TPU kernel also stores Hq; its traceback
// never reads it, so this kernel does not: H, E1, E2 and CODE are 16 bytes
// per cell, in device memory.
//
// What bounds it on this card: as poa_win.cu, latency, not bytes or
// operations — per row a few dependent L2 round trips for the row's
// metadata and predecessor rows, a block-wide prefix max for the F
// channels and a barrier; per round a scalar walk, traceback and threading
// in thread 0.  The code chase shortens the traceback's chain of
// dependent loads to one per step (plus the F origin scan, one load per
// column) and costs the fill the slot tracking and the code word; the
// per-row barriers are unchanged, so timing this kernel beside poa_win.cu
// on the same block weighs what the chase saves against what the codes
// cost.
// Scores are int32 with the floor NEG = -2^30 (no int16 clamp).
//
// STAGE is _pallas_core's profiling knob (poa_pallas_fused.py:86-93), a
// template parameter so that the stage-0 instantiation is the kernel
// itself: 0 the full kernel; 1 fill + end cell (no code chase, no
// threading); 2 fill + code chase (no threading); 3 threading without the
// ring scan past the target; 4 threading without node creation or edge
// bookkeeping; 5 fill without the F prefix scan (H = Hq); 6 fill without
// the code word; 7 fill without the predecessor-slot loop.  Stages 5-7 also
// skip the chase and the threading.  A nonzero stage is for timing: its
// graphs are invalid by design.
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

using CL = CodeLayout<7>;
constexpr int PCAP_MAX = 8;

// Per-block scratch: the graph tables (poa_graph.cuh), then the DP planes
// H E1 E2 CODE, each (VW + 1) x LW int32 — mirrored by
// CodeCaps.scratch_words in ops/poa_code.py.
template <int STAGE>
__global__ void __launch_bounds__(NT)
poa_code_kernel(const int8_t* __restrict__ seqs, const int32_t* __restrict__ slen,
                const int32_t* __restrict__ nseq, const int32_t* __restrict__ params,
                int32_t* meta, int32_t* exp_, int32_t* paths, int32_t* scratch,
                int RW, int LW, int VW, int pcap, int local, int banded) {
    extern __shared__ int8_t s_seq[];        // the round's sequence, LW bytes
    __shared__ int s_w1[2][NWARP], s_w2[2][NWARP];
    __shared__ int s_rv[NWARP], s_rr[NWARP];
    __shared__ int s_ovf, s_V, s_Vc, s_head, s_gs, s_D;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t v1 = (size_t)VW + 1;
    const size_t plane = v1 * (size_t)LW;
    int32_t* sc = scratch + (size_t)b * (graph_words(v1, pcap, LW) + 4 * plane);
    Graph k;
    int32_t* H = graph_carve(k, sc, v1, pcap, LW);
    int32_t* E1 = H + plane;
    int32_t* E2 = E1 + plane;
    int32_t* CC = E2 + plane;

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
        ovf = L0 < 1 || L0 > VW || maxL > LW - 1;
    }
    if (tid == 0) { s_ovf = ovf; s_Vc = L0; s_head = 0; s_gs = 0; }
    if (!ovf) {
        // row 0: the virtual source
        for (int j = tid; j < LW; j += NT) {
            H[j] = (local || j == 0) ? 0
                 : max(-(g + (j - 1) * e), -(q + (j - 1) * c));
            E1[j] = NEG; E2[j] = NEG; CC[j] = 0;
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
        if (tid == 0) s_V = topo_walk(k, s_head);
        __syncthreads();
        const int V = s_V;
        row_preds_par(k, V, tid, NT);
        __syncthreads();
        if (banded) {
            if (tid == 0) s_D = band_ranks(k, V);
            __syncthreads();
        }
        band_rows_par(k, V, L, banded, wb + (wfm * L) / 1000,
                      banded ? s_D : 0, tid, NT);
        __syncthreads();

        // ---- DP fill, one row per topological position ----
        int tbest = INT_MIN, trow = 0;        // local end cell, per thread
        int buf = 0;
        for (int i = 1; i <= V; ++i) {
            const int v = k.rnode[i];
            const int np = k.rnp[i];
            const int bv = k.base[v];
            const int blo = k.rlo[i], bhi = k.rhi[i];
            int prow[PCAP_MAX];
            const int npr = np > 0 ? np : 1;
            for (int p = 0; p < (STAGE == 7 ? 0 : npr); ++p)
                prow[p] = pred_row(k, i, p);
            int carry1 = NEG, carry2 = NEG;
            int rowbest = INT_MIN;
            int32_t* Hi = H + (size_t)i * LW;
            int32_t* E1i = E1 + (size_t)i * LW;
            int32_t* E2i = E2 + (size_t)i * LW;
            int32_t* Ci = CC + (size_t)i * LW;
            for (int t0 = 0; t0 <= L; t0 += TILE) {
                const int jb = t0 + tid * CPT;
                int hq[CPT], cw[CPT];
                int t1 = INT_MIN, t2 = INT_MIN;
                if (jb <= L) {
                    // predecessor maxima of H at columns jb-1 .. jb+CPT-1
                    // and of E1, E2 at jb .. jb+CPT-1, each with the first
                    // slot that holds it
                    int hp[CPT + 1], hs[CPT + 1];
                    int x1[CPT], s1[CPT], x2[CPT], s2[CPT];
                    if (STAGE == 7) {     // no predecessor-slot loop
                        for (int x = 0; x <= CPT; ++x) {
                            hp[x] = NEG + npr; hs[x] = 0;
                        }
                        for (int x = 0; x < CPT; ++x) {
                            x1[x] = NEG; s1[x] = 0; x2[x] = NEG; s2[x] = 0;
                        }
                    }
                    for (int p = 0; p < (STAGE == 7 ? 0 : npr); ++p) {
                        const size_t rb = (size_t)prow[p] * LW;
                        for (int x = 0; x <= CPT; ++x) {
                            const int j = jb - 1 + x;
                            const int h = (j >= 0 && j <= L) ? H[rb + j] : NEG;
                            if (p == 0 || h > hp[x]) { hp[x] = h; hs[x] = p; }
                        }
                        for (int x = 0; x < CPT; ++x) {
                            const int j = jb + x;
                            const int a = j <= L ? E1[rb + j] : NEG;
                            const int d = j <= L ? E2[rb + j] : NEG;
                            if (p == 0 || a > x1[x]) { x1[x] = a; s1[x] = p; }
                            if (p == 0 || d > x2[x]) { x2[x] = d; s2[x] = p; }
                        }
                    }
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        if (j > L) { hq[x] = NEG; cw[x] = 0; continue; }
                        const int M = j == 0 ? NEG
                            : hp[x] + ((int)s_seq[j - 1] == bv ? m : -n);
                        const int o1 = hp[x + 1] - g, x1e = x1[x] - e;
                        const int o2 = hp[x + 1] - q, x2e = x2[x] - c;
                        const int op1 = o1 >= x1e, op2 = o2 >= x2e;
                        int e1 = max(max(o1, x1e), NEG);
                        int e2 = max(max(o2, x2e), NEG);
                        int h = max(M, max(e1, e2));
                        int code = hs[x]
                            | ((op1 ? hs[x + 1] : s1[x]) << CL::E1S)
                            | (op1 << CL::E1O)
                            | ((op2 ? hs[x + 1] : s2[x]) << CL::E2S)
                            | (op2 << CL::E2O);
                        if (local) {
                            h = max(h, 0);
                            code |= (h == 0) << CL::HQZ;
                        }
                        code |= (M == h ? 0 : (e1 == h ? 1 : 2)) << CL::SEL;
                        if (j < blo || j > bhi) { h = NEG; e1 = NEG; e2 = NEG; }
                        hq[x] = h;
                        cw[x] = code;
                        E1i[j] = e1; E2i[j] = e2;
                        t1 = max(t1, h + e * j);
                        t2 = max(t2, h + c * j);
                    }
                }
                // block-wide exclusive prefix max of the thread totals
                int ex1 = INT_MIN, ex2 = INT_MIN, tot1 = INT_MIN,
                    tot2 = INT_MIN;
                if (STAGE != 5)
                    block_excl_max2(t1, t2, ex1, ex2, tot1, tot2, s_w1[buf],
                                    s_w2[buf]);
                int g1 = max(carry1, ex1), g2 = max(carry2, ex2);
                if (jb <= L) {
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        if (j > L) break;
                        const int h0 = hq[x];
                        int f1 = NEG, f2 = NEG;
                        if (STAGE == 5) {         // no F scan: H = Hq
                            f1 = h0; f2 = h0;
                        } else if (j > 0) {
                            f1 = g1 - g - e * (j - 1);
                            f2 = g2 - q - c * (j - 1);
                        }
                        int h = max(h0, max(f1, f2));
                        const int u1 = h0 + e * j, u2 = h0 + c * j;
                        const int n1 = STAGE == 5 || u1 >= g1,
                                  n2 = STAGE == 5 || u2 >= g2;
                        g1 = max(g1, u1);
                        g2 = max(g2, u2);
                        if (j < blo || j > bhi) h = NEG;
                        else rowbest = max(rowbest, h);
                        Hi[j] = h;
                        if (STAGE != 6) {         // 6: no code word
                            Ci[j] = cw[x] | ((h0 == h) << CL::HQEQ)
                                | ((f1 == h) << CL::F1H)
                                | ((f2 == h) << CL::F2H)
                                | (n1 << CL::F1N) | (n2 << CL::F2N);
                        }
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
                const int h = H[(size_t)i * LW + L];
                if (h > hb) { hb = h; hr = i; }
            }
            if (hr == 0) hr = INT_MAX;           // no sink in this thread
            reduce_best(hb, hr, s_rv, s_rr);
            ei = hr == INT_MAX ? 0 : hr;      // (a DAG always has a sink)
            ej = L;
        }

        // ---- code chase, then threading (thread 0, no barrier between:
        // s_ovf is read by the other threads only after the round's end
        // barrier); stages 1 and 5-7 stop at the end cell ----
        if (tid == 0 && STAGE != 1 && STAGE < 5) {
            int o = 0;
            if (have) {
                if (local) {
                    const int32_t* row = H + (size_t)ei * LW;
                    int j = 0;
                    while (row[j] != tbest) ++j;
                    ej = j;
                }
                o = code_chase<7>(k, CC, LW, ei, ej, local);
            }
            if (!o && STAGE != 2) {
                int Vc = s_Vc, head = s_head, gs = s_gs;
                o = thread_seq<STAGE>(k, s_seq, L, VW, Vc, head, gs,
                                      bpaths + (size_t)r * LW);
                s_Vc = Vc; s_head = head; s_gs = gs;
            }
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

constexpr int STAGES = 8;

template <int S>
int launch_stage(const void* seqs, const void* slen, const void* nseq,
                 const void* params, void* meta, void* exp_, void* paths,
                 void* scratch, int B, int RW, int LW, int VW, int pcap,
                 int local, int banded, size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            poa_code_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    poa_code_kernel<S><<<B, NT, smem, stream>>>(
        (const int8_t*)seqs, (const int32_t*)slen, (const int32_t*)nseq,
        (const int32_t*)params, (int32_t*)meta, (int32_t*)exp_,
        (int32_t*)paths, (int32_t*)scratch, RW, LW, VW, pcap, local, banded);
    return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*,
                         void*, void*, void*, void*, int, int, int, int, int,
                         int, int, size_t, cudaStream_t);
constexpr LaunchFn STAGE_LAUNCH[STAGES] = {
    launch_stage<0>, launch_stage<1>, launch_stage<2>, launch_stage<3>,
    launch_stage<4>, launch_stage<5>, launch_stage<6>, launch_stage<7>};

}  // namespace

extern "C" {

// Launch stage `stage` (0 = the kernel; 1-7 the profiling cuts above) on
// `stream` (PyTorch's current stream).  Returns cudaGetLastError() after
// the launch: nonzero means the launch was refused or an earlier
// asynchronous fault is pending, and the caller raises.
int poa_code_launch(const void* seqs, const void* slen, const void* nseq,
                    const void* params, void* meta, void* exp_, void* paths,
                    void* scratch, int B, int RW, int LW, int VW, int pcap,
                    int stage, int local, int banded, void* stream) {
    if (B <= 0) return 0;
    if (pcap < 1 || pcap > PCAP_MAX || stage < 0 || stage >= STAGES)
        return (int)cudaErrorInvalidValue;
    const size_t smem = ((size_t)LW + 15) & ~(size_t)15;
    return STAGE_LAUNCH[stage](seqs, slen, nseq, params, meta, exp_, paths,
                         scratch, B, RW, LW, VW, pcap, local, banded, smem,
                         (cudaStream_t)stream);
}

}  // extern "C"
