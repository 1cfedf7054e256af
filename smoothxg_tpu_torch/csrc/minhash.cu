// minhash.cu — the split stage's batched MinHash on Hopper (sm_90a).
//
// Replaces the jitted XLA functions of smoothxg_tpu/ops/minhash_jax.py:
// _compiled (:101): `hashes_fn` (:107) and `inter_fn` (:139), the device
// route of `--device-split-minhash`: all pairwise mash distances of a
// block's sequences, from canonical k-mer hash sets (k <= 16, so a k-mer
// packs into 32 bits and the hash space is uint32).  Two entries:
//
//   minhash_hash: one thread per (row, position j).  The k-mer starting at
//     j as a 2-bit pack, forward and reverse complement (:113-118, the
//     JAX roll wraps at the row's end, which only positions past the valid
//     ones reach), the canonical one (the smaller), murmur3's fmix32; the
//     0xFFFFFFFF sentinel where the k-mer holds a non-ACGT code or runs
//     past the row's length (:119-128).  A valid k-mer whose hash is the
//     sentinel value is dropped with the padding, as the JAX function does
//     (ROADMAP C2).  Out: int32 (B, L), each uint32 hash stored as its
//     sort key h ^ 0x80000000 read as signed: signed order is the hashes'
//     unsigned order and the sentinel, 0x7FFFFFFF, stays the largest key.
//     The per-row sort and dedup that follow are torch.sort calls in the
//     wrapper (ops/minhash_cuda.py:minhash_hashes), as they were XLA sorts,
//     and move 4 B a hash, as the JAX function's uint32 sorts do.
//   minhash_inter: one warp per pair (a, b) of rows of the sorted unique
//     hash sets (sentinel padding after each row's `counts` uniques).
//     |A ∩ B| by a merge: lane l takes the l-th 32nd of A's uniques, finds
//     the lower bound of its first value in B's uniques by binary search,
//     then walks both in step, counting equal values; a shuffle sum adds
//     the lanes.  The JAX function sorted each pair's concatenation instead
//     (:139-146); the count is the same, since both rows are sets.
//
// The distances are computed on the host in float64 from these integer
// counts, so they are bit-identical to the plain version's and the numpy
// mirror's.
//
// What bounds it on this card (the function's own work, chip_smoke.py's
// bounds).  Bytes: the hash reads the codes once (1 B a position) and
// writes 4 B a position; the intersection reads the hash rows once (4 B a
// hash) and the pairs (8 B) and writes 4 B a pair.  Operations: a rolling
// canonical k-mer plus fmix32, ~21 integer operations a position (this
// kernel re-walks all k bases at every position instead: simple, and far
// below the launch's cost at a block's sizes); the merge ~4 a hash of both
// rows.  At a block's sizes (hundreds of sequences of ~1 kb) launch and
// the torch.sort between the two entries dominate.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned SENTINEL = 0xFFFFFFFFu;
constexpr unsigned KEY_FLIP = 0x80000000u;   // uint32 order as int32 order

__device__ __forceinline__ unsigned fmix32(unsigned x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__global__ void minhash_hash_kernel(const int8_t* __restrict__ codes,
                                    const int* __restrict__ lens,
                                    int* __restrict__ h, int B, int L,
                                    int k) {
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (long long)B * L) return;
    const int row = (int)(gid / L), j = (int)(gid % L);
    const int8_t* c = codes + (long long)row * L;
    bool ok = j < lens[row] - (k - 1);
    unsigned fwd = 0, rev = 0;
    for (int i = 0; i < k; ++i) {
        int q = j + i;
        q = q >= L ? q - L : q;
        const int ci = c[q];
        fwd = (fwd << 2) | (unsigned)(ci & 3);
        rev |= (unsigned)(3 ^ (ci & 3)) << (2 * i);
        ok = ok && ci >= 0;
    }
    const unsigned canon = fwd < rev ? fwd : rev;
    h[gid] = (int)((ok ? fmix32(canon) : SENTINEL) ^ KEY_FLIP);
}

__global__ void minhash_inter_kernel(const int* __restrict__ hs,
                                     const int* __restrict__ counts,
                                     const int* __restrict__ pa,
                                     const int* __restrict__ pb,
                                     int* __restrict__ inter, int H, int P) {
    const long long warp =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= P) return;            // a whole warp leaves together
    const int* A = hs + (long long)pa[warp] * H;
    const int* Bv = hs + (long long)pb[warp] * H;
    const int ca = counts[pa[warp]], cb = counts[pb[warp]];
    const int lo = (int)((long long)ca * lane / 32);
    const int hi = (int)((long long)ca * (lane + 1) / 32);
    int n = 0;
    if (lo < hi) {
        const int first = A[lo];
        int l = 0, r = cb;
        while (l < r) {
            const int mid = (l + r) >> 1;
            if (Bv[mid] < first)
                l = mid + 1;
            else
                r = mid;
        }
        int i = lo, j = l;
        while (i < hi && j < cb) {
            const int av = A[i], bv = Bv[j];
            if (av == bv) {
                ++n;
                ++i;
                ++j;
            } else if (av < bv) {
                ++i;
            } else {
                ++j;
            }
        }
    }
    for (int off = 16; off > 0; off >>= 1)
        n += __shfl_xor_sync(0xffffffffu, n, off);
    if (lane == 0) inter[warp] = n;
}

constexpr int THREADS = 256;

}  // namespace

// Hash every k-mer position of a (B, L) int8 code batch (-1 = pad or
// invalid) with row lengths `lens` into h (B, L) int32 sort keys; returns the
// launch's CUDA error (0 on success).
extern "C" int minhash_hash_launch(const int8_t* codes, const int* lens,
                                   int* h, int B, int L, int k,
                                   cudaStream_t stream) {
    if (B < 0 || L < 1 || k < 1 || k > 16) return cudaErrorInvalidValue;
    const long long n = (long long)B * L;
    if (n == 0) return cudaSuccess;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    minhash_hash_kernel<<<grid, THREADS, 0, stream>>>(codes, lens, h, B, L,
                                                      k);
    return cudaGetLastError();
}

// |A ∩ B| of the P row pairs (pa[t], pb[t]) of the sorted unique hash sets
// keys hs (rows of H, `counts` uniques each) into inter (P,) int32.
extern "C" int minhash_inter_launch(const int* hs, const int* counts,
                                    const int* pa, const int* pb, int* inter,
                                    int H, int P, cudaStream_t stream) {
    if (H < 1 || P < 0) return cudaErrorInvalidValue;
    if (P == 0) return cudaSuccess;
    const long long threads = (long long)P * 32;
    const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
    minhash_inter_kernel<<<grid, THREADS, 0, stream>>>(hs, counts, pa, pb,
                                                       inter, H, P);
    return cudaGetLastError();
}
