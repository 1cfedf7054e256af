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
// Design: one thread block a pair, one thread a band column (blockDim.x =
// band, a multiple of 32 up to 1,024), every pair of the launch at once.
// A row publishes the previous row's state to shared memory and reads it
// back shifted (one barrier); the prefix minimum runs on packed keys
// (value << 32 | column), so the minimum of the keys is the earliest
// column of the smallest value: a warp shuffle scan, then the totals of the
// warps before it (two more barriers).  The payload of the chosen column
// is read from shared memory.
//
// What bounds it on this card.  Operations: ~60 int32 operations a cell
// (the three channels with their payloads and the scan), la x band cells a
// pair; at 132 SMs x 128 int32 lanes x 1.98 GHz that is ~33 T ops/s, so a
// block's few thousand pairs of ~1 kb take well under a millisecond of
// arithmetic.  Bytes: a and b read once.  The row is a chain of three
// barriers and a 5-step shuffle scan, so a pair's latency (la rows) and not
// either floor bounds a launch of few pairs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int INF = 1 << 28;

__device__ __forceinline__ long long lmin(long long a, long long b) {
    return a < b ? a : b;
}

__global__ void ident_kernel(const uint8_t* __restrict__ a_all,
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

}  // namespace

// Scores and counts of P pairs (a, b) — a the longer, both as bytes at
// their offsets into a_all / b_all — into out (P, 4) int32: score,
// matches, mismatches, gap openings.  Returns the launch's CUDA error.
extern "C" int ident_launch(const uint8_t* a_all, const long long* aoff,
                            const int* la, const uint8_t* b_all,
                            const long long* boff, const int* lb, int* out,
                            int P, int band, int X, int O, int E,
                            cudaStream_t stream) {
    if (P < 0 || band < 32 || band > 1024 || band % 32 != 0)
        return cudaErrorInvalidValue;
    if (P == 0) return cudaSuccess;
    const int smem = smem_bytes(band);
    if (smem > 48 * 1024) {
        const cudaError_t err = (cudaError_t)cudaFuncSetAttribute(
            ident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    ident_kernel<<<P, band, smem, stream>>>(a_all, aoff, la, b_all, boff, lb,
                                            out, X, O, E);
    return cudaGetLastError();
}
