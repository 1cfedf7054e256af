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
// per cell, in device memory, at the launch's row stride LS (the batch's
// longest sequence + 1, rounded up to 32 columns) rather than the caps' LW.
//
// What bounds it on this card: latency, not bytes or operations — per row
// the predecessor rows' L2 round trip, a block-wide prefix max for the F
// channels and two barriers; per round a scalar walk, traceback and
// threading in thread 0.  The design:
//   * planes at LS, so a launch's scratch follows its sequences and the
//     engine fits ~4x more blocks into a launch at the main path's ~1.1 kb;
//   * at most 128 registers (slot fields packed 3 bits a column, the
//     predecessor loop unrolled over the 8 slots, no local arrays), so two
//     256-thread blocks share an SM and cover each other's barriers;
//   * each thread reads its 8 columns of a predecessor row as two int4
//     loads per plane, and the next row's metadata (count, base, band,
//     predecessor rows: one level of loads, all independent) is issued
//     before this row's scan, so a row's predecessor loads start at once;
//   * the graph tables (poa_graph.cuh, 45 B a node) sit in shared memory
//     when they fit beside the launch's blocks per SM, so the walk, chase
//     and threading in thread 0 step through shared memory instead of L2.
// The row-end barrier stays: the next row reads this row's H at each
// thread's left neighbour, written by another thread.
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
#include "smem.cuh"

namespace {

using CL = CodeLayout<7>;
constexpr int PCAP_MAX = 8;
constexpr int STATIC_SMEM = 1024;    // above the kernel's static buffers

// device scratch of one POA block: the graph tables (used when they stay
// in device memory), then the int32 planes H E1 E2 CODE, each (VW + 1) x
// LS — mirrored by CodeCaps.scratch_words in ops/poa_code.py
__host__ __device__ inline size_t block_bytes(size_t v1, int pcap, int LS,
                                              int banded) {
    return table_bytes(v1, pcap, LS, banded) + 16 * v1 * (size_t)LS;
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

// predecessor row of slot p (row 0, the virtual source, without any)
__device__ __forceinline__ int meta_row(const RowMeta& r, int p) {
    return r.np > 0 ? (r.pr[p >> 1] >> (16 * (p & 1))) & 0xFFFF : 0;
}

__device__ __forceinline__ int part(const int4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ int slot3(unsigned s, int x) {
    return (int)(s >> (3 * x)) & 7;
}

template <int STAGE, bool SMEM_TABLES>
__global__ void __launch_bounds__(NT, 2)
poa_code_kernel(const int8_t* __restrict__ seqs, const int32_t* __restrict__ slen,
                const int32_t* __restrict__ nseq, const int32_t* __restrict__ params,
                int32_t* meta, int32_t* exp_, int32_t* paths, int8_t* scratch,
                int RW, int LW, int VW, int pcap, int LS, int local,
                int banded) {
    // dynamic: the tables (when in shared memory), then the round's
    // sequence (LS bytes)
    extern __shared__ int4 s_dyn[];
    __shared__ int s_w1[2][NWARP], s_w2[2][NWARP];
    __shared__ int s_rv[NWARP], s_rr[NWARP];
    __shared__ int s_ovf, s_V, s_Vc, s_head, s_gs, s_D;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t v1 = (size_t)VW + 1;
    const size_t tb = table_bytes(v1, pcap, LS, banded);
    const size_t plane = v1 * (size_t)LS;
    int8_t* sm = (int8_t*)s_dyn;
    int8_t* sc = scratch + (size_t)b * block_bytes(v1, pcap, LS, banded);
    Tables k;
    graph_carve(k, SMEM_TABLES ? sm : sc, v1, pcap, LS, banded);
    int8_t* s_seq = sm + (SMEM_TABLES ? tb : 0);
    int32_t* H = (int32_t*)(sc + tb);
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

    // ---- capacity check (every thread computes the same verdict; LS is
    // above every length that fits LW, see poa_code_launch) ----
    int ovf = (R < 1 || R > RW);
    int L0 = 0;
    if (!ovf) {
        L0 = lens[0];
        int maxL = 0;
        for (int r = 0; r < R; ++r) maxL = max(maxL, lens[r]);
        ovf = L0 < 1 || L0 > VW || maxL > LW - 1 || maxL > LS - 1;
    }
    if (tid == 0) { s_ovf = ovf; s_Vc = L0; s_head = 0; s_gs = 0; }
    if (!ovf) {
        // row 0: the virtual source
        for (int j = tid; j < LS; j += NT) {
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
            band_rows_par(k, V, L, wb + (wfm * L) / 1000, s_D, tid, NT);
            __syncthreads();
        }

        // ---- DP fill, one row per topological position ----
        int tbest = INT_MIN, trow = 0;        // local end cell, per thread
        int buf = 0;
        RowMeta cur = row_meta(k, 1, L, pcap, banded), nxt = cur;
        for (int i = 1; i <= V; ++i) {
            const int npr = cur.np > 0 ? cur.np : 1;
            int carry1 = NEG, carry2 = NEG;
            int rowbest = INT_MIN;
            int32_t* Hi = H + (size_t)i * LS;
            int32_t* E1i = E1 + (size_t)i * LS;
            int32_t* E2i = E2 + (size_t)i * LS;
            int32_t* Ci = CC + (size_t)i * LS;
            for (int t0 = 0; t0 <= L; t0 += TILE) {
                const int jb = t0 + tid * CPT;
                int hq[CPT], cw[CPT];
                int t1 = INT_MIN, t2 = INT_MIN;
                if (jb <= L) {
                    // predecessor maxima of H at columns jb-1 .. jb+CPT-1
                    // and of E1, E2 at jb .. jb+CPT-1, each with the first
                    // slot that holds it (3 bits a column)
                    int hp[CPT + 1], x1[CPT], x2[CPT];
                    unsigned hs = 0, s1 = 0, s2 = 0;
                    if (STAGE == 7) {     // no predecessor-slot loop
#pragma unroll
                        for (int x = 0; x <= CPT; ++x) hp[x] = NEG + npr;
#pragma unroll
                        for (int x = 0; x < CPT; ++x) { x1[x] = NEG; x2[x] = NEG; }
                    }
#pragma unroll
                    for (int p = 0; p < PCAP_MAX; ++p) {
                        if (STAGE == 7 || p >= npr) break;
                        const int32_t* rb = H + (size_t)meta_row(cur, p) * LS
                                          + jb;
                        const int4 a0 = ((const int4*)rb)[0];
                        const int4 a1 = ((const int4*)rb)[1];
                        const int4 b0 = ((const int4*)(rb + plane))[0];
                        const int4 b1 = ((const int4*)(rb + plane))[1];
                        const int4 d0 = ((const int4*)(rb + 2 * plane))[0];
                        const int4 d1 = ((const int4*)(rb + 2 * plane))[1];
                        const int hl = jb > 0 ? rb[-1] : NEG;
                        if (p == 0 || hl > hp[0]) {
                            hp[0] = hl;
                            hs = (hs & ~7u) | (unsigned)p;
                        }
#pragma unroll
                        for (int x = 0; x < CPT; ++x) {
                            const int h = part(x < 4 ? a0 : a1, x & 3);
                            const int y1 = part(x < 4 ? b0 : b1, x & 3);
                            const int y2 = part(x < 4 ? d0 : d1, x & 3);
                            const unsigned clr = ~(7u << (3 * x)),
                                           set = (unsigned)p << (3 * x);
                            if (p == 0) {
                                hp[x + 1] = h; x1[x] = y1; x2[x] = y2;
                                continue;
                            }
                            if (h > hp[x + 1]) {
                                hp[x + 1] = h;
                                hs = (hs & ~(7u << (3 * x + 3)))
                                   | ((unsigned)p << (3 * x + 3));
                            }
                            if (y1 > x1[x]) { x1[x] = y1; s1 = (s1 & clr) | set; }
                            if (y2 > x2[x]) { x2[x] = y2; s2 = (s2 & clr) | set; }
                        }
                    }
#pragma unroll
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        int e1 = NEG, e2 = NEG;
                        hq[x] = NEG;
                        cw[x] = 0;
                        if (j <= L) {
                            const int M = j == 0 ? NEG
                                : hp[x] + ((int)s_seq[j - 1] == cur.bv ? m : -n);
                            const int o1 = hp[x + 1] - g, x1e = x1[x] - e;
                            const int o2 = hp[x + 1] - q, x2e = x2[x] - c;
                            const int op1 = o1 >= x1e, op2 = o2 >= x2e;
                            e1 = max(max(o1, x1e), NEG);
                            e2 = max(max(o2, x2e), NEG);
                            int h = max(M, max(e1, e2));
                            const int hsn = slot3(hs, x + 1);
                            int code = slot3(hs, x)
                                | ((op1 ? hsn : slot3(s1, x)) << CL::E1S)
                                | (op1 << CL::E1O)
                                | ((op2 ? hsn : slot3(s2, x)) << CL::E2S)
                                | (op2 << CL::E2O);
                            if (local) {
                                h = max(h, 0);
                                code |= (h == 0) << CL::HQZ;
                            }
                            code |= (M == h ? 0 : (e1 == h ? 1 : 2)) << CL::SEL;
                            if (j < cur.blo || j > cur.bhi) {
                                h = NEG; e1 = NEG; e2 = NEG;
                            }
                            hq[x] = h;
                            cw[x] = code;
                            t1 = max(t1, h + e * j);
                            t2 = max(t2, h + c * j);
                        }
                        x1[x] = e1;
                        x2[x] = e2;
                    }
                    ((int4*)(E1i + jb))[0] = make_int4(x1[0], x1[1], x1[2], x1[3]);
                    ((int4*)(E1i + jb))[1] = make_int4(x1[4], x1[5], x1[6], x1[7]);
                    ((int4*)(E2i + jb))[0] = make_int4(x2[0], x2[1], x2[2], x2[3]);
                    ((int4*)(E2i + jb))[1] = make_int4(x2[4], x2[5], x2[6], x2[7]);
                }
                // the next row's metadata, one level of independent loads
                // that land while this row scans and finishes
                if (t0 == 0 && i < V) nxt = row_meta(k, i + 1, L, pcap, banded);
                // block-wide exclusive prefix max of the thread totals
                int ex1 = INT_MIN, ex2 = INT_MIN, tot1 = INT_MIN,
                    tot2 = INT_MIN;
                if (STAGE != 5)
                    block_excl_max2(t1, t2, ex1, ex2, tot1, tot2, s_w1[buf],
                                    s_w2[buf]);
                int g1 = max(carry1, ex1), g2 = max(carry2, ex2);
                if (jb <= L) {
                    int hv[CPT];
#pragma unroll
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        hv[x] = NEG;
                        if (j > L) { cw[x] = 0; continue; }
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
                        if (j < cur.blo || j > cur.bhi) h = NEG;
                        else rowbest = max(rowbest, h);
                        hv[x] = h;
                        cw[x] |= ((h0 == h) << CL::HQEQ)
                            | ((f1 == h) << CL::F1H) | ((f2 == h) << CL::F2H)
                            | (n1 << CL::F1N) | (n2 << CL::F2N);
                    }
                    ((int4*)(Hi + jb))[0] = make_int4(hv[0], hv[1], hv[2], hv[3]);
                    ((int4*)(Hi + jb))[1] = make_int4(hv[4], hv[5], hv[6], hv[7]);
                    if (STAGE != 6) {             // 6: no code word
                        ((int4*)(Ci + jb))[0] = make_int4(cw[0], cw[1], cw[2], cw[3]);
                        ((int4*)(Ci + jb))[1] = make_int4(cw[4], cw[5], cw[6], cw[7]);
                    }
                }
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
            int hb = NEG - 1, hr = 0;
            for (int i = 1 + tid; i <= V; i += NT) {
                if (k.nsucc[k.rnode[i]] != 0) continue;
                const int h = H[(size_t)i * LS + L];
                if (h > hb) { hb = h; hr = i; }
            }
            if (hr == 0) hr = INT_MAX;           // no sink in this thread
            reduce_best(hb, hr, s_rv, s_rr);
            ei = hr == INT_MAX ? 0 : hr;      // (a DAG always has a sink)
            ej = L;
        }

        // ---- code chase, then threading (thread 0, no barrier between:
        // s_ovf is read by the other threads only after the round's end
        // barrier); stages 1 and 5-7 stop at the end cell.  The local end
        // cell's column, the first holding the best, is found by warp 0,
        // 32 columns a step ----
        if (tid < 32 && STAGE != 1 && STAGE < 5 && local && have) {
            const int32_t* row = H + (size_t)ei * LS;
            for (int c0 = 0; c0 <= L; c0 += 32) {
                const int j = c0 + tid;
                const unsigned hit =
                    __ballot_sync(FULL, j <= L && row[j] == tbest);
                if (hit) { ej = c0 + __ffs(hit) - 1; break; }
            }
        }
        if (tid == 0 && STAGE != 1 && STAGE < 5) {
            int o = have ? code_chase<7>(k, CC, LS, ei, ej, local) : 0;
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

inline cudaError_t code_geometry(int B, int VW, int pcap, int LS,
                                 int banded, Geometry& g) {
    return one_block_geometry(B, table_bytes((size_t)VW + 1, pcap, LS,
                                             banded),
                              LS, STATIC_SMEM, g);
}

constexpr int STAGES = 8;

template <int S, bool T>
cudaError_t launch_stage(const Geometry& geo, const void* seqs,
                         const void* slen, const void* nseq,
                         const void* params, void* meta, void* exp_,
                         void* paths, void* scratch, int RW, int LW, int VW,
                         int pcap, int LS, int local, int banded,
                         cudaStream_t stream) {
    const cudaError_t err = opt_in_smem(poa_code_kernel<S, T>, geo.smem);
    if (err != cudaSuccess) return err;
    poa_code_kernel<S, T><<<geo.grid, NT, geo.smem, stream>>>(
        (const int8_t*)seqs, (const int32_t*)slen, (const int32_t*)nseq,
        (const int32_t*)params, (int32_t*)meta, (int32_t*)exp_,
        (int32_t*)paths, (int8_t*)scratch, RW, LW, VW, pcap, LS, local,
        banded);
    return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Geometry&, const void*, const void*,
                                 const void*, const void*, void*, void*,
                                 void*, void*, int, int, int, int, int, int,
                                 int, cudaStream_t);
constexpr LaunchFn STAGE_LAUNCH[STAGES][2] = {
    {launch_stage<0, false>, launch_stage<0, true>},
    {launch_stage<1, false>, launch_stage<1, true>},
    {launch_stage<2, false>, launch_stage<2, true>},
    {launch_stage<3, false>, launch_stage<3, true>},
    {launch_stage<4, false>, launch_stage<4, true>},
    {launch_stage<5, false>, launch_stage<5, true>},
    {launch_stage<6, false>, launch_stage<6, true>},
    {launch_stage<7, false>, launch_stage<7, true>}};

inline bool bad_shape(int VW, int pcap, int LS) {
    return pcap < 1 || pcap > PCAP_MAX || VW < 1 || VW > VW_MAX ||
           LS < 32 || LS % 32 != 0;
}

}  // namespace

extern "C" {

// The launch geometry of `B` POA blocks at these capacities and row
// stride on the current device: out = (POA blocks per thread block (1),
// grid, dynamic shared bytes, tables in shared memory).  Returns a CUDA
// error.
int poa_code_geometry(int B, int VW, int pcap, int LS, int banded,
                      int* out) {
    if (B <= 0 || bad_shape(VW, pcap, LS)) return (int)cudaErrorInvalidValue;
    Geometry g;
    const cudaError_t err = code_geometry(B, VW, pcap, LS, banded, g);
    if (err == cudaSuccess) geometry_out(g, out);
    return (int)err;
}

// Launch stage `stage` (0 = the kernel; 1-7 the profiling cuts above) on
// `stream` (PyTorch's current stream) in the geometry above, with DP rows
// of LS columns (a multiple of 32 above every sequence length that fits
// LW, ops/poa_win.py:row_stride) and `scratch` holding B blocks of
// block_bytes.  Returns cudaGetLastError() after the launch: nonzero means
// the launch was refused or an earlier asynchronous fault is pending, and
// the caller raises.
int poa_code_launch(const void* seqs, const void* slen, const void* nseq,
                    const void* params, void* meta, void* exp_, void* paths,
                    void* scratch, int B, int RW, int LW, int VW, int pcap,
                    int stage, int LS, int local, int banded, void* stream) {
    if (B <= 0) return 0;
    if (bad_shape(VW, pcap, LS) || stage < 0 || stage >= STAGES)
        return (int)cudaErrorInvalidValue;
    Geometry geo;
    const cudaError_t err = code_geometry(B, VW, pcap, LS, banded, geo);
    if (err != cudaSuccess) return (int)err;
    return (int)STAGE_LAUNCH[stage][geo.tables](
        geo, seqs, slen, nseq, params, meta, exp_, paths, scratch, RW, LW,
        VW, pcap, LS, local, banded, (cudaStream_t)stream);
}

}  // extern "C"
