// minhash.cu — the split stage's batched MinHash on Hopper (sm_90a).
//
// Replaces the jitted XLA functions of smoothxg_tpu/ops/minhash_jax.py:
// _compiled (:101): `hashes_fn` (:107) and `inter_fn` (:139), the device
// route of `--device-split-minhash`: all pairwise mash distances of a
// block's sequences, from canonical k-mer hash sets (k <= 16, so a k-mer
// packs into 32 bits and the hash space is uint32).  Hashes travel as int32
// sort keys h ^ 0x80000000: signed order is the hashes' unsigned order and
// the sentinel 0xFFFFFFFF, key 0x7FFFFFFF, stays the largest.  A valid
// k-mer whose hash is the sentinel value is dropped with the padding, as
// the JAX function does (ROADMAP C2).  The distances are computed on the
// host in float64 from the integer counts, so they are bit-identical to the
// plain versions' and the numpy mirror's.
//
// minhash_hash: the whole of hashes_fn, one thread block a row.
//   1. The row's codes are loaded into shared memory (coalesced bytes).
//   2. Each thread takes a run of consecutive k-mer start positions and
//      builds the canonical k-mer rolling (forward pack, reverse
//      complement and the run of valid bases, k - 1 warm-up steps), then
//      murmur3's fmix32; the key, or the sentinel's where the window holds
//      a non-ACGT code, goes to shared memory.
//   3. The n = len - k + 1 keys are sorted in shared memory by a bitonic
//      network in its all-ascending form (each merge starts with a "flip"
//      comparator, i against the mirror of i in its block): no comparator
//      ever moves a key past n, so n need not be a power of two and the
//      network skips the comparators that reach past it.  Passes that span
//      at most 64 keys stay inside one warp's keys and are ordered by warp
//      barriers (15 block barriers for a 2,048-key row instead of 66).  The
//      sort is data-oblivious, so the result does not depend on timing.
//   4. Dedup by comparing neighbours and compaction by a block prefix sum
//      (warp ballots), in chunks of blockDim keys; the sorted uniques go
//      to the row's output, then sentinel padding, and the count.
//   A row whose keys and codes (5 B a position) do not fit a block's
//   shared memory takes the same kernel instantiated with its keys in
//   device memory: the output row itself is the sort's buffer (the
//   compaction writes each unique at or before where it was read, and the
//   chunk's reads precede its writes by a barrier).  The wrapper picks the
//   route by the batch's row length alone (ops/minhash_cuda.py).
//
// minhash_inter: |A ∩ B| of every pair a < b of the sorted unique rows,
// out in np.triu_indices order.  The JAX function sorted each pair's
// concatenation; a merge gives the same count, since both rows are sets.
//   Tiles: one thread block a tile (ta, tb), ta <= tb, of the triangle of
//   row tiles of R rows.  It stages its rows' `counts` uniques (16 B loads
//   where the row stride allows) into shared memory, each followed by an
//   INF pad, so each row is read from device memory once a tile rather
//   than once a pair.  Each pair's merge path (ca + cb positions) is cut
//   into blockDim / pairs equal stretches and each thread takes (pair,
//   stretch) units: it finds its stretch's start by a binary search on the
//   merge path (ties go A first), then walks it holding the two heads in
//   registers and loading only the side that moves, one shared load a
//   step; an A value consumed while equal to the B head is a match, added
//   to the pair's count in shared memory.  A thread's loop stays inside
//   one pair (an earlier design that let a stretch run on into the next
//   pair made the compiler copy the loop's registers every step).  A block
//   of the pipeline's size (2-8 rows of <= ~1,100 hashes) is one tile: one
//   thread block.
//   Long rows: where two row slots do not fit a block's shared memory, a
//   block takes one pair and walks its merge path in segments of SEG
//   merged elements: thread 0 finds the segment's end by a binary search
//   in device memory, the block stages the segment's A and B stretches
//   with the next value of each as its pad (so a match across the boundary
//   is still seen), and its threads split the segment the same way.
//
// What bounds it on this card (the function's own work, tools/
// time_minhash.py:bounds).  Bytes: the hash reads the codes once (1 B a
// position) and writes 4 B a position; the intersection reads the hash
// rows once (4 B a hash) and writes 4 B a pair.  Operations: a rolling
// canonical k-mer plus fmix32, ~21 integer operations a position; the merge
// ~4 a hash of both rows of each pair.  The sort's log^2 passes and the
// merge's ~14 instructions and one scattered shared load a step are the
// kernels' own cost above that (the loads' bank conflicts set the merge's
// floor); at a pipeline block's sizes the launch itself dominates.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "smem.cuh"

namespace {

constexpr unsigned SENTINEL = 0xFFFFFFFFu;
constexpr unsigned KEY_FLIP = 0x80000000u;   // uint32 order as int32 order
constexpr int SENTINEL_KEY = 0x7FFFFFFF;     // SENTINEL ^ KEY_FLIP
constexpr int INF = 0x7FFFFFFF;              // a merge pad: above any unique
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// dynamic shared memory a block may take (an H100's 227 KB opt-in less
// room for the static arrays)
constexpr int SMEM_MAX = 232448 - 1024;
constexpr int TILE_ROWS_MAX = 32;
constexpr int SEG = 16384;                   // merged elements a segment

__device__ __forceinline__ unsigned fmix32(unsigned x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__device__ __forceinline__ void order(int* keys, int lo, int hi) {
    const int a = keys[lo], b = keys[hi];
    if (a > b) {
        keys[lo] = b;
        keys[hi] = a;
    }
}

// Sort keys[0, n) ascending with the block's threads: the bitonic network
// with flip comparators (every comparator puts the smaller key at the lower
// index), padded to a power of two N by virtual largest keys whose
// comparators are skipped.  Thread t takes comparators t, t + blockDim, ...,
// so the comparators of a pass that spans at most 64 keys (a flip block of
// s <= 64, a half-cleaner of j <= 32) touch only the 64-key chunks of the
// warp that owns them: between two such passes a warp barrier suffices.
__device__ void sort_keys(int* keys, int n) {
    int N = 1;
    while (N < n) N <<= 1;
    const int half = N >> 1;
    bool prev_local = false;
    auto barrier = [&](bool local) {
        if (local && prev_local)
            __syncwarp();
        else
            __syncthreads();
        prev_local = local;
    };
    for (int s = 2; s <= N; s <<= 1) {
        const int h = s >> 1;
        barrier(s <= 64);
        for (int q = threadIdx.x; q < half; q += blockDim.x) {
            const int o = q & (h - 1);
            const int lo = 2 * q - o;
            const int hi = lo + s - 1 - 2 * o;
            if (hi < n) order(keys, lo, hi);
        }
        for (int j = h >> 1; j > 0; j >>= 1) {
            barrier(j <= 32);
            for (int q = threadIdx.x; q < half; q += blockDim.x) {
                const int lo = 2 * q - (q & (j - 1));
                if (lo + j < n) order(keys, lo, lo + j);
            }
        }
    }
    __syncthreads();
}

// One block a row.  DEVICE_KEYS: the keys are sorted in the row's output
// (device memory) and the codes read from device memory; else both sit in
// shared memory (keys[nmax], then the codes).
template <bool DEVICE_KEYS>
__global__ void __launch_bounds__(MAX_THREADS, 4)
minhash_hash_kernel(const int8_t* __restrict__ codes,
                    const int* __restrict__ lens, int* hs,
                    int* __restrict__ counts, int L, int k) {
    extern __shared__ int smem[];
    __shared__ int wtot[MAX_WARPS];
    const long long row = blockIdx.x;
    const int T = blockDim.x, t = threadIdx.x;
    const int len = min(max(lens[row], 0), L);
    const int n = max(len - (k - 1), 0);
    int* out = hs + row * L;
    int* keys = DEVICE_KEYS ? out : smem;
    const int8_t* c = codes + row * L;
    if (!DEVICE_KEYS) {
        int8_t* sc = reinterpret_cast<int8_t*>(smem + max(L - (k - 1), 0));
        for (int i = t; i < len; i += T) sc[i] = c[i];
        c = sc;
        __syncthreads();
    }
    const int p0 = (int)((long long)n * t / T);
    const int p1 = (int)((long long)n * (t + 1) / T);
    if (p0 < p1) {
        const unsigned mask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
        const int top = 2 * (k - 1);
        unsigned fwd = 0, rev = 0;
        int run = 0;
        for (int i = p0; i < p1 + k - 1; ++i) {
            const int ci = c[i];
            const unsigned b = (unsigned)(ci & 3);
            fwd = ((fwd << 2) | b) & mask;
            rev = (rev >> 2) | ((3u ^ b) << top);
            run = ci >= 0 ? run + 1 : 0;
            if (i >= p0 + k - 1) {
                const unsigned canon = fwd < rev ? fwd : rev;
                keys[i - (k - 1)] =
                    (int)((run >= k ? fmix32(canon) : SENTINEL) ^ KEY_FLIP);
            }
        }
    }
    sort_keys(keys, n);
    const int lane = t & 31, warp = t >> 5, nw = T >> 5;
    int total = 0;
    for (int base = 0; base < n; base += T) {
        const int i = base + t;
        int v = SENTINEL_KEY;
        bool keep = false;
        if (i < n) {
            v = keys[i];
            keep = v != SENTINEL_KEY && (i == 0 || keys[i - 1] != v);
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) wtot[warp] = __popc(bal);
        __syncthreads();
        int off = total;
        for (int w = 0; w < nw; ++w) {
            const int x = wtot[w];
            off += w < warp ? x : 0;
            total += x;
        }
        if (keep) out[off + __popc(bal & ((1u << lane) - 1u))] = v;
        __syncthreads();
    }
    for (int e = total + t; e < L; e += T) out[e] = SENTINEL_KEY;
    if (t == 0) counts[row] = total;
}

// dynamic shared bytes of a tile of R rows with slots of wpr words: 2 R
// slots and the pairs' matches (R R)
long long tile_smem(int R, int wpr) {
    return 4LL * (2LL * R * wpr + (long long)R * R);
}

// threads a hash block: one a comparator of a sort pass of the batch's
// longest row, 32 to 512
int hash_threads(int nmax) {
    int N = 1;
    while (N < nmax) N <<= 1;
    const int t = N / 2;
    return t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t;
}

// The entry of the a-th row of a triangle (row a holding m - a entries) at
// which row a starts.
__device__ __forceinline__ long long tri_start(long long a, long long m) {
    return a * m - a * (a - 1) / 2;
}

// (a, b) of the t-th entry, row-major, of the pairs a <= b < n (diag) or
// a < b < n of n rows.
__device__ void unrank(long long t, int n, bool diag, int& a, int& b) {
    const long long m = diag ? n : n - 1;
    const double q = 2.0 * (double)m + 1.0;
    long long x = (long long)((q - sqrt(q * q - 8.0 * (double)t)) / 2.0);
    if (x < 0) x = 0;
    if (x > m - 1) x = m - 1;
    while (x > 0 && tri_start(x, m) > t) --x;
    while (tri_start(x + 1, m) <= t) ++x;
    a = (int)x;
    b = (int)(x + (diag ? 0 : 1) + (t - tri_start(x, m)));
}

// The point of merge position d0 on the merge path of A = base[oa, oa +
// ca) and Bv = base[ob, ob + cb): pa = oa + the A values before it, pb = ob
// + the B values before it.  Ties go A first.  Offsets into one shared
// array keep every load a shared load.
__device__ __forceinline__ void merge_split(const int* base, int oa, int ca,
                                            int ob, int cb, int d0, int& pa,
                                            int& pb) {
    int lo = max(0, d0 - cb), hi = min(d0, ca);
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (base[oa + mid] <= base[ob + d0 - mid - 1])
            lo = mid + 1;
        else
            hi = mid;
    }
    pa = oa + lo;
    pb = ob + d0 - lo;
}

// Matches in `steps` steps of the merge from the heads base[pa] (A) and
// base[pb] (B), each row followed by its pad: consume the smaller head, A
// on ties, count an A value equal to the B head, and load only the side
// that moved.  The heads are byte offsets into the shared array, so a step
// is a compare, two predicated adds, a select and one shared load.
__device__ __forceinline__ int merge_walk(const int* base, int pa, int pb,
                                          int steps) {
    const char* sm = reinterpret_cast<const char*>(base);
    unsigned ua = 4u * pa, ub = 4u * pb;
    int a = *reinterpret_cast<const int*>(sm + ua);
    int b = *reinterpret_cast<const int*>(sm + ub);
    int n = 0;
#pragma unroll 4
    for (int x = 0; x < steps; ++x) {
        const bool ta = a <= b;
        n += a == b;
        ua += ta ? 4u : 0u;
        ub += ta ? 0u : 4u;
        const int v = *reinterpret_cast<const int*>(sm + (ta ? ua : ub));
        a = ta ? v : a;
        b = ta ? b : v;
    }
    return n;
}

__device__ __forceinline__ int warp_sum(int n) {
    for (int off = 16; off > 0; off >>= 1)
        n += __shfl_xor_sync(0xffffffffu, n, off);
    return n;
}

// The tile's p-th pair as slots (ia, ib): a < b inside a diagonal tile of
// na rows, else row ia of the first na slots against row ib - na of the
// next nb.
__device__ __forceinline__ void tile_pair(int p, bool diag, int na, int nb,
                                          int& ia, int& ib) {
    if (diag) {
        unrank(p, na, false, ia, ib);
    } else {
        ia = p / nb;
        ib = na + p % nb;
    }
}

// One block a tile (ta, tb) of R x R rows; slots of wpr words, then the
// pairs' matches (R R words).  Each pair's merge path is cut into `parts`
// equal stretches, parts = blockDim / pairs (at least 1), and thread t
// takes units t, t + blockDim, ... of the (pair, stretch) units: a thread's
// loop stays inside one pair, so it needs no pair switch, and the warp's
// threads take as many steps as each other where the pairs are alike.
__global__ void __launch_bounds__(MAX_THREADS, 2)
minhash_inter_kernel(const int* __restrict__ hs,
                     const int* __restrict__ counts, int* __restrict__ out,
                     int B, int H, int R, int wpr, int vec) {
    extern __shared__ int smem[];
    __shared__ int cnt[2 * TILE_ROWS_MAX];
    int* hits = smem + 2 * R * wpr;
    int ta, tb;
    unrank(blockIdx.x, (B + R - 1) / R, true, ta, tb);
    const int a0 = ta * R, b0 = tb * R;
    const int na = min(R, B - a0), nb = min(R, B - b0);
    const bool diag = ta == tb;
    const int rows = diag ? na : na + nb;
    const int np = diag ? na * (na - 1) / 2 : na * nb;
    const int T = blockDim.x, t = threadIdx.x;
    const int warp = t >> 5, lane = t & 31, nw = T >> 5;
    for (int r = t; r < rows; r += T) {
        const int row = r < na ? a0 + r : b0 + r - na;
        cnt[r] = min(max(counts[row], 0), H);
    }
    for (int p = t; p < np; p += T) hits[p] = 0;
    __syncthreads();
    for (int r = warp; r < rows; r += nw) {
        const int row = r < na ? a0 + r : b0 + r - na;
        const int* src = hs + (long long)row * H;
        int* dst = smem + r * wpr;
        const int c = cnt[r];
        if (vec) {
            for (int q = lane; 4 * q <= c; q += 32) {
                int4 v = make_int4(INF, INF, INF, INF);
                if (4 * q < c) v = reinterpret_cast<const int4*>(src)[q];
                if (4 * q + 1 > c) v.x = INF;
                if (4 * q + 2 > c) v.y = INF;
                if (4 * q + 3 > c) v.z = INF;
                if (4 * q + 4 > c) v.w = INF;
                reinterpret_cast<int4*>(dst)[q] = v;
            }
        } else {
            for (int e = lane; e <= c; e += 32) dst[e] = e < c ? src[e] : INF;
        }
    }
    __syncthreads();
    const int parts = np && np < T ? T / np : 1;
    for (int u = t; u < np * parts; u += T) {
        const int p = u / parts, part = u - p * parts;
        int ia, ib;
        tile_pair(p, diag, na, nb, ia, ib);
        const int ca = cnt[ia], cb = cnt[ib];
        if (!ca || !cb) continue;
        const int len = ca + cb;
        const int d0 = (int)((long long)len * part / parts);
        const int d1 = (int)((long long)len * (part + 1) / parts);
        int pa, pb;
        merge_split(smem, ia * wpr, ca, ib * wpr, cb, d0, pa, pb);
        const int m = merge_walk(smem, pa, pb, d1 - d0);
        if (m) atomicAdd(&hits[p], m);
    }
    __syncthreads();
    for (int p = t; p < np; p += T) {
        int ia, ib;
        tile_pair(p, diag, na, nb, ia, ib);
        const int a = a0 + ia, b = diag ? a0 + ib : b0 + ib - na;
        out[tri_start(a, B - 1) + (b - a - 1)] = hits[p];
    }
}

// One block a pair (the t-th of the triangle), its merge path staged in
// segments of SEG merged elements.
__global__ void __launch_bounds__(MAX_THREADS, 2)
minhash_inter_long_kernel(const int* __restrict__ hs,
                          const int* __restrict__ counts,
                          int* __restrict__ out, int B, int H) {
    extern __shared__ int smem[];
    __shared__ int split[2];
    __shared__ int wsum[MAX_WARPS];
    int a, b;
    unrank(blockIdx.x, B, false, a, b);
    const int* A = hs + (long long)a * H;
    const int* Bv = hs + (long long)b * H;
    const int ca = min(max(counts[a], 0), H), cb = min(max(counts[b], 0), H);
    const int total = ca && cb ? ca + cb : 0;
    int n = 0, i0 = 0, j0 = 0;
    for (int d0 = 0; d0 < total; d0 += SEG) {
        const int d1 = min(total, d0 + SEG);
        if (threadIdx.x == 0) {
            int lo = max(0, d1 - cb), hi = min(d1, ca);
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (A[mid] <= Bv[d1 - mid - 1])
                    lo = mid + 1;
                else
                    hi = mid;
            }
            split[0] = lo;
            split[1] = d1 - lo;
        }
        __syncthreads();
        const int i1 = split[0], j1 = split[1];
        const int sa = i1 - i0, sb = j1 - j0;
        for (int e = threadIdx.x; e <= sa; e += blockDim.x)
            smem[e] = i0 + e < ca ? A[i0 + e] : INF;
        for (int e = threadIdx.x; e <= sb; e += blockDim.x)
            smem[sa + 1 + e] = j0 + e < cb ? Bv[j0 + e] : INF;
        __syncthreads();
        const int x0 = (int)((long long)(sa + sb) * threadIdx.x / blockDim.x);
        const int x1 =
            (int)((long long)(sa + sb) * (threadIdx.x + 1) / blockDim.x);
        int pa, pb;
        merge_split(smem, 0, sa, sa + 1, sb, x0, pa, pb);
        n += merge_walk(smem, pa, pb, x1 - x0);
        i0 = i1;
        j0 = j1;
        __syncthreads();
    }
    n = warp_sum(n);
    if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += wsum[w];
        out[blockIdx.x] = s;
    }
}

}  // namespace

// hashes_fn of a (B, L) int8 code batch (-1 = pad or invalid) with row
// lengths `lens`: hs (B, L) int32, each row's sorted unique hash keys then
// sentinel padding, and counts (B,) int32.  device_keys = 0 sorts in shared
// memory (4 B a k-mer position and 1 B a code must fit SMEM_MAX), 1 in the
// output rows.  Returns the launch's CUDA error (0 on success).
extern "C" int minhash_hash_launch(const int8_t* codes, const int* lens,
                                   int* hs, int* counts, int B, int L, int k,
                                   int device_keys, cudaStream_t stream) {
    if (B < 0 || L < 1 || k < 1 || k > 16) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const int nmax = L - (k - 1) > 0 ? L - (k - 1) : 0;
    const int threads = hash_threads(nmax);
    if (device_keys) {
        minhash_hash_kernel<true><<<B, threads, 0, stream>>>(
            codes, lens, hs, counts, L, k);
        return cudaGetLastError();
    }
    const long long smem = 4LL * nmax + L;
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    const cudaError_t err = opt_in_smem(minhash_hash_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    minhash_hash_kernel<false><<<B, threads, (size_t)smem, stream>>>(
        codes, lens, hs, counts, L, k);
    return cudaGetLastError();
}

// |A ∩ B| of every pair a < b of the B sorted unique hash key rows hs (row
// stride H, `counts` uniques each) into out (B (B - 1) / 2,) int32 in
// np.triu_indices order.  R >= 1: tiles of R rows (tile_smem: 2 R slots
// of round_up(H + 1, 4) words and the pairs' matches must fit SMEM_MAX);
// R = 0: a block a pair, in segments.
extern "C" int minhash_inter_launch(const int* hs, const int* counts,
                                    int* out, int B, int H, int R,
                                    cudaStream_t stream) {
    if (B < 0 || H < 1 || R < 0 || R > TILE_ROWS_MAX)
        return cudaErrorInvalidValue;
    if (B < 2) return cudaSuccess;
    if (R == 0) {
        const long long pairs = (long long)B * (B - 1) / 2;
        if (pairs > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
        const int smem = 4 * (SEG + 2);
        const cudaError_t err = (cudaError_t)cudaFuncSetAttribute(
            minhash_inter_long_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        minhash_inter_long_kernel<<<(unsigned)pairs, MAX_THREADS, smem,
                                    stream>>>(hs, counts, out, B, H);
        return cudaGetLastError();
    }
    const int wpr = (H + 4) & ~3;              // round_up(H + 1, 4)
    const long long smem = tile_smem(R, wpr);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    const long long T = (B + R - 1) / R;
    const long long tiles = T * (T + 1) / 2;
    const int vec = (H & 3) == 0 && ((uintptr_t)hs & 15) == 0;
    const cudaError_t err = opt_in_smem(minhash_inter_kernel, smem);
    if (err != cudaSuccess) return err;
    minhash_inter_kernel<<<(unsigned)tiles, MAX_THREADS, (size_t)smem,
                           stream>>>(hs, counts, out, B, H, R, wpr, vec);
    return cudaGetLastError();
}
