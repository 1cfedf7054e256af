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
// add(upd)`), are ordered by the key (node << 11 | pair index), so each
// node's pairs lie together in that order; the first pair of each node
// (its run's head) folds them from 0.0 in order and writes x[node] once.
// All float arithmetic goes through the _rn intrinsics, so nvcc contracts
// no multiply-add into an FMA; division is IEEE.
//
// Design: the sort never depended on x, so it is off the loop-carried
// chain.  Two kernels an iteration:
//   * sgd_plan_kernel, one thread block a minibatch, every minibatch at
//     once across the card: each term's addresses (i1 -> start, count ->
//     i2 -> node, pos), d and mu (ok kept as d's sign), and the
//     minibatch's fold order, a bitonic sort of its 2,048 keys in shared
//     memory; it writes the plan, 24 B a term: the term (n1, n2, d, mu)
//     and each pair's run word (on a run's head its start in the sorted
//     order and its length; on the others their sorted position and
//     their head).
//   * sgd_chain_kernel, one cluster of 8 thread blocks of 128 threads on
//     8 SMs, the minibatches in order, thread t of block r owning term
//     m * 1024 + r * 128 + t: read x at both ends (__ldcg), compute upd; a
//     pair alone in its run (most of them) writes x at once, the others
//     store (upd, ok) at their sorted position in the shared memory of
//     their head's block (distributed shared memory); one cluster
//     barrier; each run's head folds its run in the sorted order from its
//     own shared memory and writes x (__stcg); one cluster barrier.  Two
//     barriers a minibatch instead of
//     the sort's 66, and each SM issues an eighth of a minibatch's
//     scattered x reads and writes, which on one SM held the chain (~1
//     cycle a read, ~1.4 a write: tools/sgd_cuts.py).  Each thread copies
//     its share of the plan two minibatches ahead into a ring of three
//     slices in shared memory (cp.async, cuda_pipeline.h), so no read of
//     device memory but x's lies on the chain.
// x stays in device memory (read and written through L2; 146k nodes are
// 585 KB, which L2 holds).
//
// What bounds it on this card.  Bytes: each term reads its three draws
// (9 B), i1's start, count, node and pos (16 B), i2's node and pos (8 B)
// and x at both ends (8 B), and writes x at both ends (8 B): ~49 B a term,
// ~35 GB for 100 iterations of 7.13M terms, ~10.5 ms at 3.35 TB/s (the
// plan's 24 B a term, written and read, is this design's own traffic and
// no part of the function's bound).  The loop-carried chain: each
// minibatch waits for its x reads, one dependent L2 round trip (~0.5 us),
// and its 4,096 scattered reads and writes pass through the SMs of the
// chain (~2.6 us on one); 6,966 minibatches x 100 iterations at
// 64 x 5 Mb: 0.35-0.5 s.  The chain is the larger floor, and the chain
// kernel runs on 8 SMs while the plan kernel fills the card.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MB = 1024;          // terms a minibatch (MINIBATCH)
constexpr int PAIRS = 2 * MB;     // (node, contribution) pairs a minibatch
constexpr int IDX_BITS = 11;      // pair index bits of a sort key
constexpr unsigned POS_MASK = (1u << IDX_BITS) - 1;
// a pair's run word: a run's head, HEAD | start | length << 11 (its own
// sorted position is the start); any other pair, its sorted position |
// its head's pair index << 11
constexpr unsigned HEAD = 1u << 31;

// the plan's layout in 32-bit words, B terms: terms (4 words a term: n1,
// n2, d with ok as its sign, mu), then runs (2 words a term: the run
// words of its pairs t and 1024 + t)
struct Plan {
    int4* terms;
    uint2* runs;
};

__host__ __device__ inline Plan plan_of(int* ws, long long B) {
    Plan p;
    p.terms = reinterpret_cast<int4*>(ws);
    p.runs = reinterpret_cast<uint2*>(ws + 4 * B);
    return p;
}

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

// one block a minibatch: the terms, then the fold order of its pairs
__global__ void __launch_bounds__(MB)
sgd_plan_kernel(const int* __restrict__ node, const float* __restrict__ pos,
                const int* __restrict__ start, const int* __restrict__ count,
                const int* __restrict__ i1, const int* __restrict__ z,
                const int8_t* __restrict__ sgn, float eta, Plan plan) {
    __shared__ unsigned long long key[PAIRS];
    const int t = threadIdx.x;
    const long long m = blockIdx.x;
    const Term tm = load_term(node, pos, start, count, i1, z, sgn,
                              m * MB + t);
    float d = fabsf(__fsub_rn(tm.p1, tm.p2));
    const bool ok = tm.n1 != tm.n2 && d > 0.0f;
    d = fmaxf(d, 1e-3f);
    const float mu = fminf(__fdiv_rn(eta, __fmul_rn(d, d)), 1.0f);
    plan.terms[m * MB + t] = make_int4(tm.n1, tm.n2,
                                       __float_as_int(ok ? d : -d),
                                       __float_as_int(mu));
    key[t] = ((unsigned long long)tm.n1 << IDX_BITS) | (unsigned)t;
    key[MB + t] = ((unsigned long long)tm.n2 << IDX_BITS) | (unsigned)(MB + t);
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
    // the heads among sorted positions 2t and 2t + 1 write the run words
    // of their runs' pairs
    unsigned* runs = reinterpret_cast<unsigned*>(plan.runs);
    for (int p = 2 * t; p < 2 * t + 2; ++p) {
        const unsigned long long nd = key[p] >> IDX_BITS;
        if (p > 0 && (key[p - 1] >> IDX_BITS) == nd) continue;
        int q = p + 1;
        while (q < PAIRS && (key[q] >> IDX_BITS) == nd) ++q;
        const unsigned head = (unsigned)(key[p] & POS_MASK);
        for (int r = p; r < q; ++r) {
            const unsigned pair = (unsigned)(key[r] & POS_MASK);
            runs[2 * (m * MB + (pair & (MB - 1))) + (pair >> 10)] =
                r == p ? HEAD | (unsigned)p | ((unsigned)(q - p) << IDX_BITS)
                       : (unsigned)r | (head << IDX_BITS);
        }
    }
}

// The chain runs as one cluster of CLUSTER thread blocks on as many SMs:
// block r owns terms r * TPB .. r * TPB + TPB - 1 of every minibatch, so
// each SM issues an eighth of the minibatch's scattered x reads and
// writes.  A block's shared memory: the (upd, ok) of the runs its heads
// fold, at their sorted positions, and a ring of STAGES plan slices (its
// own terms and runs).
#ifndef SGD_CLUSTER
#define SGD_CLUSTER 8
#endif
constexpr int CLUSTER = SGD_CLUSTER;
constexpr int TPB = MB / CLUSTER;
constexpr int STAGES = 3;
struct Slice {
    int4 terms[TPB];
    uint2 runs[TPB];
};
struct ChainSmem {
    float2 fold[PAIRS];
    Slice ring[STAGES];
};

// Timing-only cuts of the chain (tools/sgd_cuts.py builds the kernel with
// -DSGD_CUTS=<mask>, and -DSGD_CLUSTER=<blocks> for other cluster sizes):
// each removes one part of the work, so x is invalid and only the time is
// read.  0, the default, cuts nothing.
#ifndef SGD_CUTS
#define SGD_CUTS 0
#endif
constexpr bool CUT_STORES = SGD_CUTS & 1;     // no write of x
constexpr bool CUT_LOADS = SGD_CUTS & 2;      // no read of x: x = the node
constexpr bool CUT_FOLD = SGD_CUTS & 4;       // no fold of runs of 2+ pairs
constexpr bool CUT_BARRIERS = SGD_CUTS & 8;   // one barrier, at the end

// a pair's part: alone in its run, the fold of one pair (its divisor
// max(0 + hit, 1) is 1, so the exact division is left out); else its
// (upd, ok) at its sorted position in the shared memory of its head's
// block (a store to distributed shared memory)
__device__ __forceinline__ void put(
    const cooperative_groups::cluster_group& cl, float* __restrict__ x,
    ChainSmem& sm, unsigned w, int nd, float x0, float v, float hit) {
    if ((w & HEAD) && (w >> IDX_BITS & 0xfff) == 1) {
        if (!CUT_STORES)
            __stcg(x + nd, __fadd_rn(x0, __fadd_rn(0.0f, v)));
        return;
    }
    const unsigned head = w & HEAD ? 0 : (w >> IDX_BITS) & POS_MASK;
    float2* fold = w & HEAD ? sm.fold
        : cl.map_shared_rank(sm.fold, (head & (MB - 1)) / TPB);
    fold[w & POS_MASK] = make_float2(v, hit);
}

// the head of a run of len >= 2 folds its pairs in the sorted order
__device__ __forceinline__ void fold_run(float* __restrict__ x, int nd,
                                         float x0, unsigned w,
                                         const float2* fold) {
    const int s = (int)(w & POS_MASK), len = (int)(w >> IDX_BITS & 0xfff);
    float acc = 0.0f, cn = 0.0f;
    for (int q = s; q < s + len; ++q) {
        acc = __fadd_rn(acc, fold[q].x);
        cn = __fadd_rn(cn, fold[q].y);
    }
    if (!CUT_STORES)
        __stcg(x + nd, __fadd_rn(x0, __fdiv_rn(acc, fmaxf(cn, 1.0f))));
    else if (acc == 12345.0f && cn == 0.5f)    // keeps the fold's loads
        x[nd] = x0;
}

// this thread's share of minibatch m's slice, copied asynchronously
__device__ __forceinline__ void fetch(Slice& s, const Plan& plan,
                                      long long m, int r, int t) {
    const long long i = m * MB + r * TPB + t;
    __pipeline_memcpy_async(&s.terms[t], &plan.terms[i], sizeof(int4));
    __pipeline_memcpy_async(&s.runs[t], &plan.runs[i], sizeof(uint2));
}

__global__ void __launch_bounds__(TPB, 1)
sgd_chain_kernel(float* __restrict__ x, Plan plan, int M) {
    extern __shared__ int4 smem[];
    ChainSmem& sm = *reinterpret_cast<ChainSmem*>(smem);
    const cooperative_groups::cluster_group cl =
        cooperative_groups::this_cluster();
    const int r = (int)cl.block_rank(), t = threadIdx.x;
    for (int m = 0; m < STAGES - 1; ++m) {
        if (m < M) fetch(sm.ring[m], plan, m, r, t);
        __pipeline_commit();
    }
    for (int m = 0; m < M; ++m) {
        __pipeline_wait_prior(STAGES - 2);       // this thread's share of m
        const Slice& cur = sm.ring[m % STAGES];
        const int4 tm = cur.terms[t];
        const uint2 rn = cur.runs[t];
        const float x1 = CUT_LOADS ? (float)tm.x : __ldcg(x + tm.x);
        const float x2 = CUT_LOADS ? (float)tm.y : __ldcg(x + tm.y);
        // the slice minibatch m - 1 used is free since its last barrier
        if (m + STAGES - 1 < M)
            fetch(sm.ring[(m + STAGES - 1) % STAGES], plan, m + STAGES - 1,
                  r, t);
        __pipeline_commit();
        const float ds = __int_as_float(tm.z);
        const bool ok = ds > 0.0f;
        const float d = fabsf(ds);
        const float mu = __int_as_float(tm.w);
        const float dx = __fsub_rn(x1, x2);
        const float mag = __fadd_rn(fabsf(dx), 1e-9f);
        // / 2 as * 0.5: the same correctly rounded value
        const float delta = __fmul_rn(__fmul_rn(mu, __fsub_rn(mag, d)), 0.5f);
        const float rr = ok ? __fdiv_rn(delta, mag) : 0.0f;
        const float upd = __fmul_rn(rr, dx);
        const float hit = ok ? 1.0f : 0.0f;
        put(cl, x, sm, rn.x, tm.x, x1, -upd, hit);
        put(cl, x, sm, rn.y, tm.y, x2, upd, hit);
        if (!CUT_BARRIERS)
            cl.sync();            // the runs' pairs in their heads' blocks
        if (!CUT_FOLD && (rn.x & HEAD) && (rn.x >> IDX_BITS & 0xfff) > 1)
            fold_run(x, tm.x, x1, rn.x, sm.fold);
        if (!CUT_FOLD && (rn.y & HEAD) && (rn.y >> IDX_BITS & 0xfff) > 1)
            fold_run(x, tm.y, x2, rn.y, sm.fold);
        if (!CUT_BARRIERS)
            cl.sync();            // x written before the next reads
    }
    if (CUT_BARRIERS)
        cl.sync();                // no block leaves while another reads
}

}  // namespace

// The plan of one iteration of B term updates (B a multiple of 1024) into
// the workspace `ws` of 6 * B int32 words (ops/sgd.py:plan_words), on
// `stream`; returns the launch's CUDA error (0 on success).
extern "C" int sgd_plan_launch(const int* node, const float* pos,
                               const int* start, const int* count,
                               const int* i1, const int* z, const int8_t* sgn,
                               float eta, int B, int* ws,
                               cudaStream_t stream) {
    if (B < 0 || B % MB != 0) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    sgd_plan_kernel<<<B / MB, MB, 0, stream>>>(node, pos, start, count, i1,
                                               z, sgn, eta, plan_of(ws, B));
    return cudaGetLastError();
}

// The iteration planned in `ws` applied to x in place, on `stream`;
// returns the launch's CUDA error.
extern "C" int sgd_chain_launch(float* x, int* ws, int B,
                                cudaStream_t stream) {
    if (B < 0 || B % MB != 0) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const cudaError_t err = (cudaError_t)cudaFuncSetAttribute(
        sgd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(ChainSmem));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3{CLUSTER, 1, 1};
    cfg.blockDim = dim3{TPB, 1, 1};
    cfg.dynamicSmemBytes = sizeof(ChainSmem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, sgd_chain_kernel, x, plan_of(ws, B),
                                   B / MB);
}
