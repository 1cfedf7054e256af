// ident.cu — the split stage's banded identity DP on Hopper (sm_90a).
//
// Replaces the jitted XLA function smoothxg_tpu/ops/ident_jax.py:_compiled
// (:62, `run` :77-206), the device route of `--device-split-wfa`: for each
// pair (a, b) with len(a) >= len(b), a banded affine DP along a (one row a
// base of a) over a window of `band` columns of b that follows the
// diagonal, carrying in every cell the (matches, mismatches, gap openings)
// of the optimal path reaching it.  The score and the three counts at the
// final cell (la, lb) are the outputs; the gap-compressed identity
// matches / (matches + mismatches + gap openings) is computed on the host
// in float64, bit-identical to the plain version's and the numpy mirror's.
//
// Per row i (= the (i-1)-th base of a):
//   * the window's first column is c_i = clip(i * lb / la - band / 2, 0,
//     max(lb - band + 1, 0)), computed in int64 (ident_jax.py:83 computes
//     i * lb in int32, which wraps past ~46,340 bp: ROADMAP C3); it moves
//     by 0 or 1 a row, and the previous row's state shifts with it;
//   * I, the gap along a (same column): min(H + o + e, I + e), H first on
//     ties; M, the diagonal: H(j-1) + (0 or mismatch), INF stays INF;
//     Hq = min(M, I), M first on ties;
//   * D, the gap along b (same row), D(j) = min_{k<j} Hq(k) + o + e (j - k):
//     an exclusive prefix minimum of Hq(k) - e k, the earliest k on ties
//     (the JAX scan's left-preferring combine, :68-75), then
//     H = min(Hq, D), Hq first on ties; cells past lb are INF.
// Scores and counts are int32; INF = 2^28 as in the JAX function.
//
// Design: one warp a pair for bands up to 256 columns (the pipeline's
// 128 and the 32-256 the wrapper takes), lane l holding the C = band / 32
// consecutive columns l C .. l C + C - 1 with the state and its payloads
// in registers; 4 warps, so 4 pairs, a thread block, and a launch of 2,048
// pairs fills the card in one wave.  A row needs no barrier and no shared
// memory: the window's shift (0 or 1 column) moves each state field one
// register left and takes the right lane's first column by
// __shfl_down_sync; the diagonal takes the left lane's last column by
// __shfl_up_sync; the prefix minimum runs serially over the lane's C
// columns, then as a 5-step shuffle scan of the lane minima, the left
// lane's on ties (its columns come first), so the earliest column of the
// smallest value wins, as the block kernel's packed keys (value << 32 |
// column) make it.  Every lane's exclusive prefix covers whole lanes, so
// its argmin is the local argmin of one lane, whose payload (the three
// counts) comes by one shuffle each.  The window's first column follows
// i * lb / la as a quotient and remainder advanced a row at a time (no
// division), and a and b are read a row ahead.  One kernel a column count
// C = 1 .. 8 (template).  Bands of 288-1,024 columns keep the block
// kernel: one thread block a pair, one thread a band column; a row
// publishes the previous row's state to shared memory and reads it back
// shifted (one barrier), and the scan adds the totals of the warps before
// it (two more barriers).
//
// What bounds it on this card.  Operations: the recurrence needs 38 int32
// operations a cell as one sequential row (the count of chip_smoke.py:
// OPS_IDENT_CELL), la x band cells a pair; at 132 SMs x 128 int32 lanes x
// 1.98 GHz (~33 T ops/s) the smoke's 2,048 pairs of ~1.4 kb at band 128
// take ~0.43 ms.  Bytes: a and b read once, 16 B a pair written.  A row of
// the warp kernel is a dependent chain of ~8 shuffles and the lane's
// serial scan, ~250 instructions a warp; with ~4 warps a scheduler the
// launch sits between that latency and the issue rate.
#include <cuda_runtime.h>

#include <cstdint>

#include "smem.cuh"

namespace {

constexpr int INF = 1 << 28;

__device__ __forceinline__ long long lmin(long long a, long long b) {
    return a < b ? a : b;
}

__global__ void ident_block_kernel(const uint8_t* __restrict__ a_all,
                             const long long* __restrict__ aoff,
                             const int* __restrict__ la_,
                             const uint8_t* __restrict__ b_all,
                             const long long* __restrict__ boff,
                             const int* __restrict__ lb_,
                             int* __restrict__ out, int X, int O, int E) {
    extern __shared__ int smem[];
    const int BW = blockDim.x;
    const int p = threadIdx.x, lane = p & 31, warp = p >> 5;
    const int pair = blockIdx.x;
    // shared: the packed prefix keys and the warp totals (8-byte aligned
    // at the base), the previous row's state, and Hq's payload
    long long* incl = reinterpret_cast<long long*>(smem);
    long long* wtot = incl + BW;
    int* sH = reinterpret_cast<int*>(wtot + 32);
    int* sHm = sH + BW;
    int* sHx = sHm + BW;
    int* sHg = sHx + BW;
    int* sI = sHg + BW;
    int* sIm = sI + BW;
    int* sIx = sIm + BW;
    int* sIg = sIx + BW;
    int* qm = sIg + BW;
    int* qx = qm + BW;
    int* qg = qx + BW;

    const uint8_t* a = a_all + aoff[pair];
    const uint8_t* b = b_all + boff[pair];
    const long long la = la_[pair], lb = lb_[pair];
    const long long half = BW / 2;
    const long long cmax = lb - BW + 1 > 0 ? lb - BW + 1 : 0;
    auto center = [&](long long i) {
        long long ci = la > 0 ? i * lb / la : 0;
        ci -= half;
        ci = ci < 0 ? 0 : ci;
        return ci > cmax ? cmax : ci;
    };

    long long c = center(0);
    const long long j0 = c + p;
    int H = j0 == 0 ? 0 : (j0 <= lb ? (int)(O + E * j0) : INF);
    int Hm = 0, Hx = 0, Hg = j0 > 0 ? 1 : 0;
    int I = INF, Im = 0, Ix = 0, Ig = 0;
    for (long long i = 1; i <= la; ++i) {
        const long long ci = center(i);
        const int d = (int)(ci - c);
        c = ci;
        sH[p] = H;
        sHm[p] = Hm;
        sHx[p] = Hx;
        sHg[p] = Hg;
        sI[p] = I;
        sIm[p] = Im;
        sIx[p] = Ix;
        sIg[p] = Ig;
        __syncthreads();
        // the previous row in this row's frame: own column and diagonal
        int Hp = INF, Hpm = 0, Hpx = 0, Hpg = 0;
        int Ip = INF, Ipm = 0, Ipx = 0, Ipg = 0;
        if (p + d < BW) {
            const int q = p + d;
            Hp = sH[q];
            Hpm = sHm[q];
            Hpx = sHx[q];
            Hpg = sHg[q];
            Ip = sI[q];
            Ipm = sIm[q];
            Ipx = sIx[q];
            Ipg = sIg[q];
        }
        int Hd = INF, Hdm = 0, Hdx = 0, Hdg = 0;
        if (p >= 1) {
            const int q = p - 1 + d;
            Hd = sH[q];
            Hdm = sHm[q];
            Hdx = sHx[q];
            Hdg = sHg[q];
        }
        // the diagonal move into column ci + p consumes b[ci + p - 1]
        const int achar = a[i - 1];
        const long long jb = ci + p - 1;
        const bool ism = p >= 1 && jb < lb && b[jb] == achar;
        // I: gap along a
        const int fromH = Hp + (O + E), fromI = Ip + E;
        const bool useH = fromH <= fromI;
        int Iv = useH ? fromH : fromI;
        const int Ivm = useH ? Hpm : Ipm, Ivx = useH ? Hpx : Ipx;
        const int Ivg = useH ? Hpg + 1 : Ipg;
        // M: diagonal
        const int Mv = Hd >= INF ? INF : Hd + (ism ? 0 : X);
        const int Mm = Hdm + (ism ? 1 : 0), Mx = Hdx + (ism ? 0 : 1);
        const bool useM = Mv <= Iv;
        const int Hq = useM ? Mv : Iv;
        const int Hqm = useM ? Mm : Ivm, Hqx = useM ? Mx : Ivx;
        const int Hqg = useM ? Hdg : Ivg;
        // D: exclusive prefix minimum of (Hq - e p, p) over the window
        const int w = Hq >= INF ? INF : Hq - E * p;
        long long key = (long long)w * 4294967296LL + p;
        qm[p] = Hqm;
        qx[p] = Hqx;
        qg[p] = Hqg;
        for (int off = 1; off < 32; off <<= 1) {
            const long long up = __shfl_up_sync(0xffffffffu, key, off);
            if (lane >= off) key = lmin(key, up);
        }
        if (lane == 31) wtot[warp] = key;
        __syncthreads();
        for (int w2 = 0; w2 < warp; ++w2) key = lmin(key, wtot[w2]);
        incl[p] = key;
        __syncthreads();
        int pv = INF, pm = 0, px = 0, pg = 0;
        if (p >= 1) {
            const long long kk = incl[p - 1];
            const int q = (int)(kk & 0xFFFFFFFFLL);
            pv = (int)((kk - q) / 4294967296LL);
            pm = qm[q];
            px = qx[q];
            pg = qg[q];
        }
        const int Dv = pv >= INF ? INF : pv + O + E * p;
        const bool useQ = Hq <= Dv;
        int Hn = useQ ? Hq : Dv;
        Hm = useQ ? Hqm : pm;
        Hx = useQ ? Hqx : px;
        Hg = useQ ? Hqg : pg + 1;
        if (ci + p > lb) {                  // past b's end
            Hn = INF;
            Iv = INF;
        }
        H = Hn;
        I = Iv;
        Im = Ivm;
        Ix = Ivx;
        Ig = Ivg;
    }
    // the final cell (la, lb) in the last row's frame
    long long pf = lb - c;
    pf = pf < 0 ? 0 : (pf > BW - 1 ? BW - 1 : pf);
    if (p == pf) {
        out[4 * pair + 0] = H;
        out[4 * pair + 1] = Hm;
        out[4 * pair + 2] = Hx;
        out[4 * pair + 3] = Hg;
    }
}

// shared bytes of a block of `band` threads: the packed keys and the warp
// totals, then eleven int planes (eight of state, three of payload)
int smem_bytes(int band) { return band * 8 + 32 * 8 + 11 * band * 4; }

constexpr int WARPS = 4;                     // pairs (warps) a thread block
constexpr unsigned FULL = 0xffffffffu;
// the exclusive prefix before the first column: above every value (they
// are at most INF), so the first column replaces it
constexpr int FILL = 0x7fffffff;

// shift a field of the window one column left: the right lane's first
// column enters at the last, `fill` past the band
template <int C>
__device__ __forceinline__ void shift_left(int (&v)[C], int fill, int lane) {
    const int in = __shfl_down_sync(FULL, v[0], 1);
#pragma unroll
    for (int k = 0; k + 1 < C; ++k) v[k] = v[k + 1];
    v[C - 1] = lane == 31 ? fill : in;
}

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
ident_warp_kernel(const uint8_t* __restrict__ a_all,
                  const long long* __restrict__ aoff,
                  const int* __restrict__ la_,
                  const uint8_t* __restrict__ b_all,
                  const long long* __restrict__ boff,
                  const int* __restrict__ lb_, int* __restrict__ out, int P,
                  int X, int O, int E) {
    constexpr int BW = 32 * C;
    const int lane = threadIdx.x & 31;
    const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (pair >= P) return;                       // the whole warp
    const uint8_t* a = a_all + aoff[pair];
    const uint8_t* b = b_all + boff[pair];
    const int la = la_[pair], lb = lb_[pair];
    const int cmax = lb - BW + 1 > 0 ? lb - BW + 1 : 0;
    const int p0 = lane * C;                     // the lane's first column
    // i * lb / la as quotient and remainder, one row at a time, in 32
    // bits: the quotient is at most lb, the remainder below la + lb
    int quo = 0;
    unsigned rem = 0;
    auto window = [&]() {
        int ci = quo - BW / 2;
        ci = ci < 0 ? 0 : ci;
        return ci > cmax ? cmax : ci;
    };
    auto advance = [&]() {
        rem += (unsigned)lb;
        while (rem >= (unsigned)la) {            // once at most: lb <= la
            rem -= (unsigned)la;
            ++quo;
        }
    };
    int c = window();
    int H[C], Hm[C], Hx[C], Hg[C], I[C], Im[C], Ix[C], Ig[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int j0 = c + p0 + k;               // at most max(lb, BW - 1)
        H[k] = j0 == 0 ? 0
             : (j0 <= lb ? (int)(O + (long long)E * j0) : INF);
        Hm[k] = Hx[k] = 0;
        Hg[k] = j0 > 0 ? 1 : 0;
        I[k] = INF;
        Im[k] = Ix[k] = Ig[k] = 0;
    }
    // the bytes of row 1: a's first, and the b byte each column's
    // diagonal consumes, b[ci + p - 1] (-1 where there is none); a row
    // whose window moves takes its right neighbour's, and the band's last
    // column loads its own
    if (la > 0) advance();
    int cn = window();
    int an = la > 0 ? a[0] : 0;
    int bn[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int jb = cn + p0 + k - 1;
        bn[k] = p0 + k >= 1 && jb < lb ? b[jb] : -1;
    }
    for (int i = 1; i <= la; ++i) {
        const int ci = cn;
        const int d = ci - c;
        c = ci;
        const int achar = an;
        int bc[C];
#pragma unroll
        for (int k = 0; k < C; ++k) bc[k] = bn[k];
        if (i < la) {                            // row i + 1's bytes
            advance();
            cn = window();
            an = a[i];
            if (cn != ci) {                      // warp-uniform
                const int jb = cn + BW - 2;      // the last column's
                shift_left<C>(bn, jb < lb ? b[jb] : -1, lane);
                if (lane == 0) bn[0] = -1;
            }
        }
        if (d) {                                 // warp-uniform
            shift_left<C>(H, INF, lane);
            shift_left<C>(Hm, 0, lane);
            shift_left<C>(Hx, 0, lane);
            shift_left<C>(Hg, 0, lane);
            shift_left<C>(I, INF, lane);
            shift_left<C>(Im, 0, lane);
            shift_left<C>(Ix, 0, lane);
            shift_left<C>(Ig, 0, lane);
        }
        // the previous row in this frame at the column left of the lane's
        // first: the diagonal of column p0
        int dH = __shfl_up_sync(FULL, H[C - 1], 1);
        int dm = __shfl_up_sync(FULL, Hm[C - 1], 1);
        int dx = __shfl_up_sync(FULL, Hx[C - 1], 1);
        int dg = __shfl_up_sync(FULL, Hg[C - 1], 1);
        if (lane == 0) {
            dH = INF;
            dm = dx = dg = 0;
        }
        int qv[C], qm[C], qx[C], qg[C], qw[C];
        int lv = FILL, lc = 0;            // the lane's minimum and its column
        int lm = 0, lx = 0, lg = 0;
#pragma unroll
        for (int k = 0; k < C; ++k) {
            const int p = p0 + k;
            const int Hd = k ? H[k - 1] : dH, Hdm = k ? Hm[k - 1] : dm;
            const int Hdx = k ? Hx[k - 1] : dx, Hdg = k ? Hg[k - 1] : dg;
            const bool ism = bc[k] == achar;
            // I: gap along a
            const int fromH = H[k] + (O + E), fromI = I[k] + E;
            const bool useH = fromH <= fromI;
            I[k] = useH ? fromH : fromI;
            Im[k] = useH ? Hm[k] : Im[k];
            Ix[k] = useH ? Hx[k] : Ix[k];
            Ig[k] = useH ? Hg[k] + 1 : Ig[k];
            // M: diagonal
            const int Mv = Hd >= INF ? INF : Hd + (ism ? 0 : X);
            const int Mm = Hdm + (ism ? 1 : 0), Mx = Hdx + (ism ? 0 : 1);
            const bool useM = Mv <= I[k];
            qv[k] = useM ? Mv : I[k];
            qm[k] = useM ? Mm : Im[k];
            qx[k] = useM ? Mx : Ix[k];
            qg[k] = useM ? Hdg : Ig[k];
            qw[k] = qv[k] >= INF ? INF : qv[k] - E * p;
            if (qw[k] < lv) {             // strict: the earliest column
                lv = qw[k];
                lc = p;
                lm = qm[k];
                lx = qx[k];
                lg = qg[k];
            }
        }
        // D: exclusive prefix minimum over the window, whole lanes first;
        // the left lanes' columns come first, so they win ties
        int iv = lv, ic = lc;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int uv = __shfl_up_sync(FULL, iv, off);
            const int uc = __shfl_up_sync(FULL, ic, off);
            if (lane >= off && uv <= iv) {
                iv = uv;
                ic = uc;
            }
        }
        int rv = __shfl_up_sync(FULL, iv, 1);
        const int src = __shfl_up_sync(FULL, ic, 1) / C;
        int rm = __shfl_sync(FULL, lm, src);
        int rx = __shfl_sync(FULL, lx, src);
        int rg = __shfl_sync(FULL, lg, src);
        if (lane == 0) {
            rv = FILL;
            rm = rx = rg = 0;
        }
#pragma unroll
        for (int k = 0; k < C; ++k) {
            const int p = p0 + k;
            const int Dv = rv >= INF ? INF : rv + O + E * p;
            const bool useQ = qv[k] <= Dv;
            H[k] = useQ ? qv[k] : Dv;
            Hm[k] = useQ ? qm[k] : rm;
            Hx[k] = useQ ? qx[k] : rx;
            Hg[k] = useQ ? qg[k] : rg + 1;
            if (qw[k] < rv) {
                rv = qw[k];
                rm = qm[k];
                rx = qx[k];
                rg = qg[k];
            }
            if (ci + p > lb) {                   // past b's end
                H[k] = INF;
                I[k] = INF;
            }
        }
    }
    // the final cell (la, lb) in the last row's frame
    int pf = lb - c;
    pf = pf < 0 ? 0 : (pf > BW - 1 ? BW - 1 : pf);
    if (lane == pf / C) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (p0 + k == pf) {
                out[4 * pair + 0] = H[k];
                out[4 * pair + 1] = Hm[k];
                out[4 * pair + 2] = Hx[k];
                out[4 * pair + 3] = Hg[k];
            }
        }
    }
}

template <int C>
int warp_launch(const uint8_t* a_all, const long long* aoff, const int* la,
                const uint8_t* b_all, const long long* boff, const int* lb,
                int* out, int P, int X, int O, int E, cudaStream_t stream) {
    ident_warp_kernel<C><<<(P + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
        a_all, aoff, la, b_all, boff, lb, out, P, X, O, E);
    return cudaGetLastError();
}

}  // namespace

// Scores and counts of P pairs (a, b) — a the longer, both as bytes at
// their offsets into a_all / b_all — into out (P, 4) int32: score,
// matches, mismatches, gap openings; a warp a pair up to 256 columns, a
// thread block a pair above.  Returns the launch's CUDA error.
extern "C" int ident_launch(const uint8_t* a_all, const long long* aoff,
                            const int* la, const uint8_t* b_all,
                            const long long* boff, const int* lb, int* out,
                            int P, int band, int X, int O, int E,
                            cudaStream_t stream) {
    if (P < 0 || band < 32 || band > 1024 || band % 32 != 0)
        return cudaErrorInvalidValue;
    if (P == 0) return cudaSuccess;
    switch (band / 32) {
        case 1: return warp_launch<1>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 2: return warp_launch<2>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 3: return warp_launch<3>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 4: return warp_launch<4>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 5: return warp_launch<5>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 6: return warp_launch<6>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 7: return warp_launch<7>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        case 8: return warp_launch<8>(a_all, aoff, la, b_all, boff, lb, out,
                                      P, X, O, E, stream);
        default: break;
    }
    const int smem = smem_bytes(band);
    const cudaError_t err = opt_in_smem(ident_block_kernel, smem);
    if (err != cudaSuccess) return err;
    ident_block_kernel<<<P, band, smem, stream>>>(a_all, aoff, la, b_all,
                                                  boff, lb, out, X, O, E);
    return cudaGetLastError();
}
