// sgd.cu — one iteration of path-guided 1D SGD on Hopper (sm_90a).
//
// Replaces the jitted XLA body smoothxg_tpu/ops/sgd.py:_compiled_run
// (:49-110, `one_iter`), the batched device route of the prep stage's
// graph sort.  An iteration applies B term updates (B a multiple of 1024)
// as B / 1024 sequential minibatches: within a minibatch the updates to one
// node are conflict-averaged, x[n] += acc[n] / max(cnt[n], 1); across
// minibatches they compound.  Term t of a minibatch samples step i1 of a
// path, a second step of the same path at the zipf rank distance z with
// sign s (reflected, then clipped into the path), and pulls the two nodes'
// positions x toward their nucleotide distance |pos[i1] - pos[i2]|:
//   mu = min(eta / d^2, 1), dx = x[n1] - x[n2], mag = |dx| + 1e-9,
//   upd = mu (mag - d) / 2 / mag * dx  (0 unless n1 != n2 and d > 0),
//   acc[n1] -= upd, acc[n2] += upd, cnt[n1] += ok, cnt[n2] += ok.
// The random draws (i1, z, s) are inputs: the wrapper draws them on the
// card from a seeded torch.Generator (ops/sgd.py:sgd_draws), so the kernel
// and its plain version, ops/sgd.py:sgd_reference, see the same ones.
//
// Deterministic, and bit-identical to the plain version: no atomics.  A
// minibatch's 2,048 (node, contribution) pairs, first the n1 side in term
// order and then the n2 side (the order of `.at[n1].add(-upd).at[n2].
// add(upd)`), are sorted in shared memory by the key (node << 11 | pair
// index), so each node's pairs lie together in that order; the first pair
// of each node folds them from 0.0 in order and writes x[node] once.  All
// float arithmetic goes through the _rn intrinsics, so nvcc contracts no
// multiply-add into an FMA; division is IEEE.
//
// Design: one thread block of 1,024 threads walks the iteration's
// minibatches in order, thread t owning term m * 1024 + t.  The address
// chain of a term (i1 -> start, count -> i2 -> node, pos) does not depend
// on x, so it is loaded one minibatch ahead, while the current minibatch
// sorts; only x[n1], x[n2] and the write of x lie on the loop-carried
// chain.  x stays in device memory (read and written through L2 with
// __ldcg / __stcg; 146k nodes are 585 KB, which L2 holds).
//
// What bounds it on this card.  Bytes: each term reads its three draws
// (9 B), i1's start, count, node and pos (16 B), i2's node and pos (8 B)
// and x at both ends (8 B), and writes x at both ends (8 B): ~49 B a term,
// ~35 GB for 100 iterations of 7.13M terms, ~10.5 ms at 3.35 TB/s.  The
// loop-carried chain: each minibatch waits for its x reads and writes, one
// dependent L2 round trip (~0.5 us) at least, 6,966 minibatches x 100
// iterations at 64 x 5 Mb: ~0.35 s.  The chain is the larger floor.  This
// first version spends most of a minibatch in the 66 barrier-separated
// stages of the 2,048-key bitonic sort.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MB = 1024;          // terms a minibatch (MINIBATCH)
constexpr int PAIRS = 2 * MB;     // (node, contribution) pairs a minibatch
constexpr int IDX_BITS = 11;      // pair index bits of a sort key

struct Term {
    int n1, n2;
    float p1, p2;
};

// the addresses of term t: step i1, its partner step i2 at rank distance
// z in the direction s (reflected when it leaves the path, then clipped)
__device__ __forceinline__ Term load_term(
    const int* __restrict__ node, const float* __restrict__ pos,
    const int* __restrict__ start, const int* __restrict__ count,
    const int* __restrict__ i1, const int* __restrict__ z,
    const int8_t* __restrict__ sgn, long long t) {
    const int a = i1[t];
    const int st = start[a], cnt = count[a];
    const int sz = (int)sgn[t] * z[t];
    const int r1 = a - st;
    int r2 = r1 + sz;
    if (r2 < 0 || r2 >= cnt) r2 = r1 - sz;
    r2 = r2 < 0 ? 0 : r2;
    r2 = r2 > cnt - 1 ? cnt - 1 : r2;
    const int b = st + r2;
    Term out;
    out.n1 = node[a];
    out.n2 = node[b];
    out.p1 = pos[a];
    out.p2 = pos[b];
    return out;
}

__global__ void __launch_bounds__(MB, 1)
sgd_iter_kernel(float* __restrict__ x, const int* __restrict__ node,
                const float* __restrict__ pos,
                const int* __restrict__ start, const int* __restrict__ count,
                const int* __restrict__ i1, const int* __restrict__ z,
                const int8_t* __restrict__ sgn, float eta, int M) {
    __shared__ unsigned long long key[PAIRS];
    __shared__ float val[PAIRS];
    __shared__ float xv[PAIRS];
    __shared__ float hit[PAIRS];
    const int t = threadIdx.x;
    Term cur = load_term(node, pos, start, count, i1, z, sgn, t);
    for (int m = 0; m < M; ++m) {
        const float x1 = __ldcg(x + cur.n1);
        const float x2 = __ldcg(x + cur.n2);
        Term nxt = cur;
        if (m + 1 < M)
            nxt = load_term(node, pos, start, count, i1, z, sgn,
                            (long long)(m + 1) * MB + t);
        float d = fabsf(__fsub_rn(cur.p1, cur.p2));
        const bool ok = cur.n1 != cur.n2 && d > 0.0f;
        d = fmaxf(d, 1e-3f);
        const float mu = fminf(__fdiv_rn(eta, __fmul_rn(d, d)), 1.0f);
        const float dx = __fsub_rn(x1, x2);
        const float mag = __fadd_rn(fabsf(dx), 1e-9f);
        const float delta = __fdiv_rn(__fmul_rn(mu, __fsub_rn(mag, d)), 2.0f);
        const float rr = ok ? __fdiv_rn(delta, mag) : 0.0f;
        const float upd = __fmul_rn(rr, dx);
        key[t] = ((unsigned long long)cur.n1 << IDX_BITS) | (unsigned)t;
        key[MB + t] =
            ((unsigned long long)cur.n2 << IDX_BITS) | (unsigned)(MB + t);
        val[t] = -upd;
        val[MB + t] = upd;
        xv[t] = x1;
        xv[MB + t] = x2;
        hit[t] = hit[MB + t] = ok ? 1.0f : 0.0f;
        __syncthreads();
        // bitonic sort of the 2,048 unique keys, ascending
        for (int k = 2; k <= PAIRS; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                const int i = 2 * t - (t & (j - 1));
                const unsigned long long a = key[i], b = key[i + j];
                if ((a > b) == ((i & k) == 0)) {
                    key[i] = b;
                    key[i + j] = a;
                }
                __syncthreads();
            }
        }
        // the first pair of each node folds the node's pairs in order
        for (int p = t; p < PAIRS; p += MB) {
            const long long nd = (long long)(key[p] >> IDX_BITS);
            if (p > 0 && (long long)(key[p - 1] >> IDX_BITS) == nd) continue;
            float acc = 0.0f, cn = 0.0f;
            const float x0 = xv[key[p] & (PAIRS - 1)];
            for (int q = p; q < PAIRS && (long long)(key[q] >> IDX_BITS) == nd;
                 ++q) {
                const int ix = (int)(key[q] & (PAIRS - 1));
                acc = __fadd_rn(acc, val[ix]);
                cn = __fadd_rn(cn, hit[ix]);
            }
            __stcg(x + nd, __fadd_rn(x0, __fdiv_rn(acc, fmaxf(cn, 1.0f))));
        }
        __syncthreads();
        cur = nxt;
    }
}

}  // namespace

// One iteration of B term updates (B a multiple of 1024) on `stream`,
// updating x in place; returns the launch's CUDA error (0 on success).
extern "C" int sgd_iter_launch(float* x, const int* node, const float* pos,
                               const int* start, const int* count,
                               const int* i1, const int* z, const int8_t* sgn,
                               float eta, int B, cudaStream_t stream) {
    if (B < 0 || B % MB != 0) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    sgd_iter_kernel<<<1, MB, 0, stream>>>(x, node, pos, start, count, i1, z,
                                          sgn, eta, B / MB);
    return cudaGetLastError();
}
