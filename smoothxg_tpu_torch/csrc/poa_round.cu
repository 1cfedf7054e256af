// poa_round.cu — one round of partial order alignment on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smoothxg_tpu/ops/poa_pallas.py:_pallas_fn
// (kernel body :71, pallas_call :404), the device half of `--engine
// pallas`.  Each task of a launch aligns one sequence against one POA
// graph whose nodes arrive in topological rows: the sequence-vs-DAG DP fill,
// the end cell, and a traceback that emits packed move codes.  The
// semantics are those of the scalar oracle smoothxg_tpu/ops/poa_host.py:
// fill/align (and of the port's copy, ops/poa_host.py), bit for bit, and
// of the plain PyTorch version smoothxg_tpu_torch/ops/poa_round.py:
// poa_round_reference, which is written line for line against this file:
//   * fill (poa_host.py:84-161): M from the max over predecessor rows of H
//     at column j-1, E1/E2 open from H or extend E, Hq = max(M, E1, E2)
//     (and 0 when local), F1/F2 as a prefix max of Hq + ext*j, H = max;
//     int32 scores with the floor NEG = -2^30 (no int16 clamp);
//   * local end cell: the first row holding the strict maximum, then the
//     first column in it; global: the sink with the highest H[., L],
//     lowest row on ties;
//   * traceback (poa_host.py:194-265): M over the predecessors in slot
//     order, then E1, then E2; F takes the nearest origin k, channel 1
//     before channel 2; an E step tries opening over the predecessors
//     before extending; local stops at value 0, global takes leading
//     insertions through row 0.
// Output contract of the Pallas kernel, with the move codes widened to 64
// bits: codes ((i+2) << 32) | (j+2) in traceback order (end to start;
// i = -1 an insertion, j = -1 a deletion), so no graph or sequence size
// overflows a code (the Pallas kernel packs (i+2) << 15 into int32, which
// bounds L + 2 below 2^15 and V + 2 below 2^16; ops/poa_round.py:
// to_pallas_layout converts), and meta = (n_moves, best score, flag, 0),
// flag 1 a stuck traceback, 2 the iteration limit overrun.  A task with
// V == 0 or L == 0 is done at once: meta = (0, NEG, 0, 0).
//
// The wrapper zeroes `codes` first, so codes past n_moves are 0.
//
// What bounds it on this card.  Operations: the recurrence needs 23 int32
// operations per DP cell when local and 21 when global (substitution 3;
// E1 and E2 4 each; Hq 2, + 1 for the local floor at 0; F1 and F2 3 each
// as F(j) = max(F(j-1) - ext, Hq(j-1) - open); H 2; the local row maximum
// 1), plus 3 per predecessor past the first (the maxima of H, E1 and E2);
// that count over the launch's cells at 132 SMs x 64 int32 lanes per clock
// is the bound (chip_smoke.py counts it from each launch's tasks).  But
// every cell depends on the rows above, so a task's V rows run one after
// another; only the L + 1 columns of a row are parallel.  Bytes: the
// inputs and codes are a few MB per launch; the four DP planes (16 B per
// cell) are scratch in device memory, written once and read by the
// successor rows and the traceback, mostly from L2.
// What the design does about it: one thread block per task, the columns of
// a row split over 256 threads (8 each, 2048 per tile), the F channels as a
// warp-shuffle scan plus a scan of the warp totals (one barrier per tile,
// poa_common.cuh), the local end cell tracked per thread during the fill
// and reduced once, the traceback in thread 0.  Parallelism across tasks
// comes from the grid, so a launch needs >= 132 tasks to fill the SMs.
// Predecessor slots past a node's in-degree repeat its first predecessor
// (the packing contract); the fill stops at the first repeat.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
//        -fPIC, one process per source, then one link into one library
//        with the other kernels (smoothxg_tpu_torch/ops/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "poa_common.cuh"

namespace {

constexpr int SHIFT = 32;
// longest sequence kept in shared memory: 32 KB leaves room for the static
// arrays under the 48 KB a launch gets without opting in; a longer one is
// read from global memory (through L1) instead
constexpr int SMEM_SEQ_MAX = 32768;

__device__ __forceinline__ int64_t move_code(int i, int j) {
    return ((int64_t)(i + 2) << SHIFT) | (int64_t)(j + 2);
}

// number of real predecessor rows of DP row i (1-based): slots past the
// in-degree repeat slot 0, and real predecessors are distinct
__device__ __forceinline__ int n_preds(const int32_t* rp, int P) {
    int np = 1;
    while (np < P && rp[np] != rp[0]) ++np;
    return np;
}

__global__ void __launch_bounds__(NT)
poa_round_kernel(const int32_t* __restrict__ nv,
                 const int32_t* __restrict__ slen,
                 const int32_t* __restrict__ par,
                 const uint8_t* __restrict__ base,
                 const uint8_t* __restrict__ sink,
                 const int32_t* __restrict__ preds,
                 const uint8_t* __restrict__ seq, int64_t* codes,
                 int32_t* meta, int32_t* scratch, int VW, int LS, int P,
                 int local) {
    extern __shared__ uint8_t s_seq[];       // the task's sequence, LS bytes
                                             // when LS <= SMEM_SEQ_MAX
    __shared__ int s_w1[2][NWARP], s_w2[2][NWARP];
    __shared__ int s_rv[NWARP], s_rr[NWARP];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int V = nv[b], L = slen[b];
    const int32_t* pp = par + (size_t)b * 6;
    const int m = pp[0], n = pp[1], g = pp[2], e = pp[3], q = pp[4],
              c = pp[5];
    const size_t C = (size_t)LS + 1;              // stored columns per row
    const size_t plane = ((size_t)VW + 1) * C;
    int32_t* H = scratch + (size_t)b * 4 * plane;
    int32_t* Hq = H + plane;
    int32_t* E1 = Hq + plane;
    int32_t* E2 = E1 + plane;
    const uint8_t* bbase = base + (size_t)b * VW;
    const uint8_t* bsink = sink + (size_t)b * VW;
    const int32_t* bpred = preds + (size_t)b * VW * P;
    const int CW = VW + LS + 1;
    int64_t* out = codes + (size_t)b * CW;
    const uint8_t* sq = LS <= SMEM_SEQ_MAX ? s_seq : seq + (size_t)b * LS;

    if (V <= 0 || L <= 0) {                       // padded or empty task
        if (tid == 0) {
            meta[4 * b] = 0; meta[4 * b + 1] = NEG;
            meta[4 * b + 2] = 0; meta[4 * b + 3] = 0;
        }
        return;
    }
    if (LS <= SMEM_SEQ_MAX)
        for (int j = tid; j < L; j += NT) s_seq[j] = seq[(size_t)b * LS + j];
    // row 0: the virtual source
    for (int j = tid; j <= L; j += NT) {
        int32_t h, hq;
        if (local || j == 0) { h = 0; hq = 0; }
        else {
            h = max(-(g + (j - 1) * e), -(q + (j - 1) * c));
            hq = NEG;
        }
        H[j] = h; Hq[j] = hq; E1[j] = NEG; E2[j] = NEG;
    }
    __syncthreads();

    // ---- DP fill, one row per topological position ----
    int tbest = INT_MIN, trow = 0;        // local end cell, per thread
    int buf = 0;
    for (int i = 1; i <= V; ++i) {
        const int32_t* rp = bpred + (size_t)(i - 1) * P;
        const int np = n_preds(rp, P);
        const int bv = bbase[i - 1];
        int carry1 = NEG, carry2 = NEG;
        int rowbest = INT_MIN;
        int32_t* Hi = H + (size_t)i * C;
        int32_t* Hqi = Hq + (size_t)i * C;
        int32_t* E1i = E1 + (size_t)i * C;
        int32_t* E2i = E2 + (size_t)i * C;
        for (int t0 = 0; t0 <= L; t0 += TILE) {
            const int jb = t0 + tid * CPT;
            int hp[CPT + 1], hq[CPT], x1[CPT], x2[CPT];
            int t1 = INT_MIN, t2 = INT_MIN;
            for (int x = 0; x <= CPT; ++x) hp[x] = NEG;
            for (int x = 0; x < CPT; ++x) { x1[x] = NEG; x2[x] = NEG; }
            if (jb <= L) {
                for (int p = 0; p < np; ++p) {
                    const size_t rb = (size_t)rp[p] * C;
                    for (int x = 0; x <= CPT; ++x) {
                        const int j = jb - 1 + x;
                        if (j >= 0 && j <= L) hp[x] = max(hp[x], H[rb + j]);
                    }
                    for (int x = 0; x < CPT; ++x) {
                        const int j = jb + x;
                        if (j <= L) {
                            x1[x] = max(x1[x], E1[rb + j]);
                            x2[x] = max(x2[x], E2[rb + j]);
                        }
                    }
                }
                for (int x = 0; x < CPT; ++x) {
                    const int j = jb + x;
                    if (j > L) { hq[x] = NEG; continue; }
                    int M = j == 0 ? NEG
                        : hp[x] + ((int)sq[j - 1] == bv ? m : -n);
                    int e1 = max(max(hp[x + 1] - g, x1[x] - e), NEG);
                    int e2 = max(max(hp[x + 1] - q, x2[x] - c), NEG);
                    int h = max(M, max(e1, e2));
                    if (local) h = max(h, 0);
                    hq[x] = h;
                    Hqi[j] = h; E1i[j] = e1; E2i[j] = e2;
                    t1 = max(t1, h + e * j);
                    t2 = max(t2, h + c * j);
                }
            }
            int ex1, ex2, tot1, tot2;
            block_excl_max2(t1, t2, ex1, ex2, tot1, tot2, s_w1[buf],
                            s_w2[buf]);
            int g1 = max(carry1, ex1), g2 = max(carry2, ex2);
            if (jb <= L) {
                for (int x = 0; x < CPT; ++x) {
                    const int j = jb + x;
                    if (j > L) break;
                    int h = hq[x];
                    if (j > 0) {
                        int f1 = g1 - g - e * (j - 1);
                        int f2 = g2 - q - c * (j - 1);
                        h = max(h, max(f1, f2));
                    }
                    g1 = max(g1, hq[x] + e * j);
                    g2 = max(g2, hq[x] + c * j);
                    rowbest = max(rowbest, h);
                    Hi[j] = h;
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
    int ei, ej, best;
    if (local) {
        reduce_best(tbest, trow, s_rv, s_rr);
        best = tbest;
        ei = trow;
        ej = 0;
    } else {
        int hb = INT_MIN, hr = INT_MAX;       // INT_MAX: no sink seen
        for (int i = 1 + tid; i <= V; i += NT) {
            if (!bsink[i - 1]) continue;
            int h = H[(size_t)i * C + L];
            if (h > hb) { hb = h; hr = i; }
        }
        reduce_best(hb, hr, s_rv, s_rr);
        best = hb;
        ei = hr == INT_MAX ? 0 : hr;          // (a DAG always has a sink)
        ej = L;
    }
    if (tid != 0) return;

    // ---- traceback by value re-derivation (thread 0) ----
    int nm = 0, flag = 0;
    if (!local || best > 0) {
        if (local) {
            const int32_t* row = H + (size_t)ei * C;
            while (row[ej] != best) ++ej;
        }
        const int lim = 2 * CW + 16;          // loop steps; V + L suffice
        int i = ei, j = ej, chan = 0;         // 0 H, 1 Hq, 2 E1, 3 E2
        int val = H[(size_t)i * C + j];
        for (int it = 0;; ++it) {
            if (it >= lim || nm >= CW) { flag = 2; break; }
            if (chan <= 1) {
                if (local && val == 0) break;
                if (i == 0) {
                    if (j == 0) break;
                    out[nm++] = move_code(-1, j - 1);  // leading insertion
                    --j;
                    val = H[j];
                    chan = 0;
                    continue;
                }
                const int32_t* rp = bpred + (size_t)(i - 1) * P;
                const int np = n_preds(rp, P);
                if (j > 0) {
                    const int subv =
                        (int)sq[j - 1] == bbase[i - 1] ? m : -n;
                    int pr = -1;
                    for (int p = 0; p < np; ++p)
                        if (H[(size_t)rp[p] * C + j - 1] + subv == val) {
                            pr = rp[p];
                            break;
                        }
                    if (pr >= 0) {
                        out[nm++] = move_code(i, j - 1);
                        i = pr; --j; chan = 0;
                        val = H[(size_t)i * C + j];
                        continue;
                    }
                }
                if (E1[(size_t)i * C + j] == val) { chan = 2; continue; }
                if (E2[(size_t)i * C + j] == val) { chan = 3; continue; }
                if (chan == 0) {
                    int kf = -1;
                    for (int k = j - 1; k >= 0; --k) {
                        const int h = Hq[(size_t)i * C + k];
                        if (h - g - (j - 1 - k) * e == val ||
                            h - q - (j - 1 - k) * c == val) { kf = k; break; }
                    }
                    if (kf >= 0) {
                        if (nm + (j - kf) > CW) { flag = 2; break; }
                        for (int t = j - 1; t >= kf; --t)
                            out[nm++] = move_code(-1, t);   // insertions
                        j = kf; chan = 1;
                        val = Hq[(size_t)i * C + j];
                        continue;
                    }
                }
                flag = 1;                     // stuck: cannot happen
                break;
            }
            // E channel: this row's node is deleted from the sequence
            const int op = chan == 2 ? g : q, ex = chan == 2 ? e : c;
            const int32_t* Em = chan == 2 ? E1 : E2;
            const int32_t* rp = bpred + (size_t)(i - 1) * P;
            const int np = n_preds(rp, P);
            out[nm++] = move_code(i, -1);
            int nxt = -1;
            for (int p = 0; p < np; ++p)
                if (H[(size_t)rp[p] * C + j] - op == val) { nxt = rp[p]; break; }
            if (nxt >= 0) {
                i = nxt; chan = 0;
                val = H[(size_t)i * C + j];
                continue;
            }
            for (int p = 0; p < np; ++p)
                if (Em[(size_t)rp[p] * C + j] - ex == val) { nxt = rp[p]; break; }
            if (nxt < 0) { flag = 1; break; }     // broken E chain
            i = nxt;
            val = Em[(size_t)i * C + j];
        }
    }
    meta[4 * b] = nm; meta[4 * b + 1] = best;
    meta[4 * b + 2] = flag; meta[4 * b + 3] = 0;
}

}  // namespace

extern "C" {

// Launch on `stream` (PyTorch's current stream).  Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused or an earlier
// asynchronous fault is pending, and the caller raises.
int poa_round_launch(const void* nv, const void* slen, const void* par,
                     const void* base, const void* sink, const void* preds,
                     const void* seq, void* codes, void* meta, void* scratch,
                     int B, int VW, int LS, int P, int local, void* stream) {
    if (B <= 0) return 0;
    if (P < 1 || VW < 1 || LS < 1) return (int)cudaErrorInvalidValue;
    size_t smem = LS <= SMEM_SEQ_MAX ? ((size_t)LS + 15) & ~(size_t)15 : 0;
    poa_round_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
        (const int32_t*)nv, (const int32_t*)slen, (const int32_t*)par,
        (const uint8_t*)base, (const uint8_t*)sink, (const int32_t*)preds,
        (const uint8_t*)seq, (int64_t*)codes, (int32_t*)meta,
        (int32_t*)scratch, VW, LS, P, local);
    return (int)cudaGetLastError();
}

}  // extern "C"
