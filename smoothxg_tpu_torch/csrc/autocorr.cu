// autocorr.cu — match counts of the batched autocorrelation screen on
// Hopper (sm_90a).
//
// Replaces the jitted XLA function smoothxg_tpu/ops/autocorr.py:_counts_fn
// (:74), the device half of `repeat_batch`: for each row b of a (B, Lpad)
// uint8 batch and each lag g of a (G,) grid, the number of positions p with
// p + lag_g < lens[b] and rows[b, p] == rows[b, p + lag_g] (the XLA
// function's roll by -lag, compare and mask: the mask keeps the roll from
// ever wrapping).  Bytes are arbitrary symbols: N and lower case count as
// their own.  The counts are exact int32; the host turns them into
// correlations and z scores in float64 (ops/autocorr.py:repeat_batch).
// Lengths are clipped to [0, Lpad]; a negative lag counts 0 (the XLA
// roll would wrap it; the port's grids never hold one).
//
// Design: a memset of the plan's header and row counters, then two kernels.
//
// * autocorr_pack_kernel, a block of 256 threads a chunk of 8,192
//   positions of a row, a thread a 32-position word: packs the row into
//   four bit planes (two planes of a 2-bit code of A/C/G/T, a plane
//   marking N, a plane marking every other byte, an "escape"), four bytes
//   at a time by zero-byte tests, and adds its N and its words holding an
//   escape to the row's counters.  The row's last chunk to finish (a
//   ticket after a fence) zeroes the row's counts, picks its route
//     0  A/C/G/T only: two planes;
//     1  with N: three planes (N is a fifth symbol of its own plane);
//     2  with a few escapes: four planes, and pairs whose two positions are
//        both escapes compared as bytes (byte_matches);
//     3  escapes in more than 3 of 10 words: the bytes themselves, 4
//        positions a word (lower case, junk, soft-masked rows, ...).  A
//        word of 32 positions with an escape on both sides sends the
//        warp to byte_matches, so route 2's cost follows the words that
//        hold an escape, not the escapes (PERF.md);
//   and cuts the row's (lag, window) work into units of equal size,
//   appended to one list: a unit is a stretch of 8 x words_of(route) words
//   (words_of a warp) times a group of 32 consecutive lags, one for each
//   stretch the group's lags reach, with the span of words its lags'
//   shifted windows cover.
// * autocorr_count_kernel, a persistent grid (the blocks an SM holds x the
//   SMs): block i takes units i, i + grid, ...  While it counts one unit,
//   cp.async stages the next one's stretch and window into the other half
//   of its shared memory, 16 bytes at a time (a group whose window the
//   half cannot hold reads device memory).  A unit's 32 lags are a warp's
//   lanes, and its stretch is cut into the 8 warps' words: each lane counts
//   its own lag over its warp's words.  The own words are the same for
//   every lane (a broadcast load); the shifted ones are cut out of two
//   words by __funnelshift_r (the second word is the next step's first,
//   so one shared load a plane a word); the planes' XORs fold into one
//   mismatch word by LOP3, and one __popc counts 32
//   positions (4 on the byte route, where a zero-byte test stands in for
//   the fold).  Words inside every lane's window need no mask.  No warp
//   reduction: at the end of a unit each lane adds its count to out[b, g]
//   by an int32 atomicAdd, exact and the same in any order.
//
// What bounds it on this card.  Operations: the smoke's 128 rows of 2-40
// kb at the CLI's grid (380 lags 1,000-19,950 every 50) hold ~571 M
// position compares.  At 32 positions a word and two lane operations a
// word at least (the XOR of one plane, the fold of the other), that is
// 16 positions a lane operation: 1.1 us at 132 SMs x 128 lanes x 1,980
// MHz.  Bytes: the rows once, 2.7 MB, 0.8 us at 3.35 TB/s.  A word here is
// ~10 instructions on route 0 (two shifted and two own shared loads, two
// funnel shifts, two LOP3, the popcount and the add), and shared
// memory serves one warp-wide load a cycle, some of them twice where two
// lanes' lags lie 32 words apart; the packing, the staging and the
// launches come on top.  PERF.md, row 30, has the times.
//
// Lpad must be a multiple of 4 and the rows 4-byte aligned (the wrapper
// pads).  `scratch` holds the plan (header, row counters, units) and the
// planes: autocorr_scratch_bytes(B, Lpad, G) bytes, 16-byte aligned.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // count kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPackThreads = 256;        // pack kernel: a thread a word
constexpr int kChunk = kPackThreads * 32;    // positions a pack block
constexpr int kLG = 32;                  // lags a unit: a lane each
constexpr int kSmemWords = 6144;         // shared budget of a count block
constexpr int kBytesWords = 10;          // route 3 past 3 escape words
constexpr int kEscapeWords = 3;          // in 10
constexpr int kHeader = 16;              // int32 header of the plan
constexpr int kMaxGroups = 1 << 15;      // lag groups a unit can name

enum { kACGT = 0, kACGTN = 1, kEscape = 2, kBytes = 3, kRoutes = 4 };

__host__ __device__ constexpr int planes_of(int r) {
    return r == kBytes ? 1 : r + 2;
}
// positions a word
__host__ __device__ constexpr int ppw_of(int r) {
    return r == kBytes ? 4 : 32;
}
// words a warp of a unit's stretch (a multiple of 4: 16-byte stretches)
__host__ __device__ constexpr int words_of(int r) {
    return r == kACGT ? 28 : r == kACGTN ? 28 : r == kEscape ? 20 : 36;
}
constexpr int kMaxWarpWords = 36;
__host__ __device__ constexpr int stretch_of(int r) {
    return kWarps * words_of(r);
}
// the words a plane of a unit's window takes in a staging buffer: its
// SW + spread + 1 words from a 16-byte boundary, rounded up to 16 bytes
__host__ __device__ constexpr int window_words(int r, int spread) {
    return (stretch_of(r) + spread + 1 + 3 + 3) & ~3;
}
// the widest lag spread (in words) whose window a buffer of `words`
// shared words stages beside its stretch (negative: none)
__host__ __device__ constexpr int spread_cap(int r, int words) {
    return (words - planes_of(r) * stretch_of(r)) / planes_of(r) -
           stretch_of(r) - 7;
}
constexpr int min_stretch_positions() {
    int m = INT_MAX;
    for (int r = 0; r < kRoutes; ++r)
        m = stretch_of(r) * ppw_of(r) < m ? stretch_of(r) * ppw_of(r) : m;
    return m;
}

__device__ __forceinline__ int clip_len(int v, int Lpad) {
    return min(max(v, 0), Lpad);
}
// words of a plane of a row in the planes buffer (16-byte rows)
__host__ __device__ __forceinline__ int plane_stride(int Lpad) {
    return (((Lpad + 31) >> 5) + 3) & ~3;
}

// bit 7 of each byte of w equal to c
__device__ __forceinline__ uint32_t bytes_eq(uint32_t w, uint32_t c) {
    const uint32_t x = w ^ (c * 0x01010101u);
    return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}
// bit 7 of byte i to bit i
__device__ __forceinline__ uint32_t gather4(uint32_t m) {
    return (((m >> 7) & 0x01010101u) * 0x01020408u) >> 24;
}

// ---------------------------------------------------------------------
// pack: a block a chunk of a row; the row's last chunk plans its units
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kPackThreads)
    autocorr_pack_kernel(const uint8_t* __restrict__ rows,
                         const int* __restrict__ lens,
                         const int* __restrict__ lags, int* __restrict__ out,
                         int* __restrict__ hdr, int* __restrict__ rowc,
                         int4* __restrict__ units,
                         uint32_t* __restrict__ planes, int Lpad, int G,
                         int chunks, int buf_words) {
    __shared__ int s_esc[2];             // the chunk's N, escape words
    __shared__ int s_last, s_route, s_base;
    __shared__ int s_warp[kPackThreads / 32];
    const int b = blockIdx.x / chunks, c = blockIdx.x % chunks;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = clip_len(lens[b], Lpad);
    const int nc = n > 0 ? (n + kChunk - 1) / kChunk : 1;
    if (c >= nc) return;                 // block-uniform
    if (blockIdx.x == 0 && tid < kRoutes) {
        hdr[8 + tid] = stretch_of(tid) * ppw_of(tid);
        if (tid == 0) {
            hdr[6] = kLG;
            hdr[7] = (int)(units - reinterpret_cast<int4*>(hdr)) * 4;
        }
    }
    if (tid < 2) s_esc[tid] = 0;
    __syncthreads();
    const int Wp = plane_stride(Lpad);
    const int k = c * kPackThreads + tid;    // the thread's word
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(rows + (size_t)b * Lpad);
    int nN = 0, nE = 0;
    if (k << 5 < n) {
        uint32_t c0 = 0, c1 = 0, isn = 0, esc = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int p = (k << 5) + 4 * j, vb = n - p;
            if (vb <= 0) break;
            const uint32_t w = row[p >> 2];
            const uint32_t valid =
                vb >= 4 ? 0x80808080u : 0x80808080u & ((1u << (8 * vb)) - 1u);
            const uint32_t acgt = (bytes_eq(w, 'A') | bytes_eq(w, 'C') |
                                   bytes_eq(w, 'G') | bytes_eq(w, 'T')) &
                                  valid;
            const uint32_t nn = bytes_eq(w, 'N') & valid;
            // the code is (byte >> 1) & 3: A 0, C 1, T 2, G 3
            c0 |= gather4((w << 6) & acgt) << (4 * j);
            c1 |= gather4((w << 5) & acgt) << (4 * j);
            isn |= gather4(nn) << (4 * j);
            esc |= gather4(valid & ~(acgt | nn)) << (4 * j);
        }
        uint32_t* pl = planes + (size_t)b * 4 * Wp + k;
        pl[0] = c0;
        pl[Wp] = c1;
        pl[2 * Wp] = isn;
        pl[3 * Wp] = esc;
        nN = __popc(isn);
        nE = esc != 0;
    }
    nN = __reduce_add_sync(0xffffffffu, nN);
    nE = __reduce_add_sync(0xffffffffu, nE);
    if (lane == 0 && (nN | nE)) {
        atomicAdd(&s_esc[0], nN);
        atomicAdd(&s_esc[1], nE);
    }
    __syncthreads();
    if (tid == 0) {
        if (s_esc[0]) atomicAdd(&rowc[3 * b], s_esc[0]);
        if (s_esc[1]) atomicAdd(&rowc[3 * b + 1], s_esc[1]);
        __threadfence();
        s_last = atomicAdd(&rowc[3 * b + 2], 1) == nc - 1;
    }
    __syncthreads();
    if (!s_last) return;
    // the row's last chunk: every chunk's counts are in
    if (tid == 0) {
        __threadfence();
        const int esc_w = atomicAdd(&rowc[3 * b + 1], 0);
        const int n_n = atomicAdd(&rowc[3 * b], 0);
        const int r =
            esc_w * kBytesWords > kEscapeWords * ((n + 31) >> 5) ? kBytes
            : esc_w > 0                                         ? kEscape
            : n_n > 0                                           ? kACGTN
                                                                : kACGT;
        s_route = r;
        atomicAdd(&hdr[1 + r], 1);
    }
    for (int g = tid; g < G; g += kPackThreads) out[(size_t)b * G + g] = 0;
    __syncthreads();
    const int r = s_route;
    const int shift = r == kBytes ? 2 : 5;
    const int span = stretch_of(r) << shift;     // positions a stretch
    const int cap = spread_cap(r, buf_words);
    const int NG = (G + kLG - 1) / kLG;
    // a thread a lag group: its stretches, then a block scan reserves
    // their places in the list
    for (int c0 = 0; c0 < NG; c0 += kPackThreads) {
        const int j = c0 + tid;
        int cnt = 0, qlo = 0, flags = 0;
        if (j < NG) {
            int lo = INT_MAX, hi = -1;
#pragma unroll
            for (int i = 0; i < kLG; ++i) {
                const int g = j * kLG + i;
                const int lag = g < G ? lags[g] : -1;
                if (lag >= 0 && lag < n) {
                    lo = min(lo, lag);
                    hi = max(hi, lag);
                }
            }
            if (hi >= 0) {
                cnt = (n - lo + span - 1) / span;
                qlo = lo >> shift;
                const int spread = (hi >> shift) - qlo;
                const int dev = spread > cap;
                flags = (j << 16) | ((dev ? 0 : spread) << 3) | (dev << 2) | r;
                if (dev) atomicAdd(&hdr[5], cnt);
            }
        }
        int inc = cnt;
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += t;
        }
        if (lane == 31) s_warp[warp] = inc;
        __syncthreads();
        if (tid == 0) {
            int sum = 0;
            for (int w = 0; w < kPackThreads / 32; ++w) {
                const int v = s_warp[w];
                s_warp[w] = sum;
                sum += v;
            }
            s_base = atomicAdd(&hdr[0], sum);
        }
        __syncthreads();
        const int base = s_base + s_warp[warp] + inc - cnt;
        for (int s = 0; s < cnt; ++s)
            units[base + s] = make_int4(b, s * stretch_of(r), qlo, flags);
        __syncthreads();
    }
}

// ---------------------------------------------------------------------
// count: a persistent grid over the units
// ---------------------------------------------------------------------

// a unit: x the row, y its first word, z the first word of its lags'
// shifted windows (its lowest lag's), w (lag group << 16) | (the lags'
// span of words << 3) | (read from device memory << 2) | route
__device__ __forceinline__ int route_of(int4 u) { return u.w & 3; }
__device__ __forceinline__ bool dev_of(int4 u) { return (u.w >> 2) & 1; }
__device__ __forceinline__ int spread_of(int4 u) {
    return (u.w >> 3) & 0x1fff;
}
__device__ __forceinline__ int group_of(int4 u) { return u.w >> 16; }

// the words of plane j of row b on route R start at src + j * Wr
template <int R>
__device__ __forceinline__ const uint32_t* plane_src(
    const uint8_t* rows, const uint32_t* planes, int b, int Lpad) {
    return R == kBytes
               ? reinterpret_cast<const uint32_t*>(rows + (size_t)b * Lpad)
               : planes + (size_t)b * 4 * plane_stride(Lpad);
}
template <int R>
__device__ __forceinline__ int plane_words(int Lpad) {
    return R == kBytes ? Lpad >> 2 : plane_stride(Lpad);
}

// stage a unit's stretch (P x SW words) and window (P x window_words,
// from the 16-byte boundary at or below its first word) into buf by
// cp.async.  The planes' rows are 16-byte aligned and the planes buffer
// has slack past its last row, so a plane route copies 16 bytes at a time
// unguarded: words past a row's length are read but always masked.  The
// byte route reads the rows themselves, 4 bytes at a time, and zeroes what
// lies past Lpad.
template <int R>
__device__ __forceinline__ void stage(int4 u, const uint8_t* rows,
                                      const uint32_t* planes, uint32_t* buf,
                                      int Lpad) {
    constexpr int P = planes_of(R), SW = stretch_of(R);
    const uint32_t* src = plane_src<R>(rows, planes, u.x, Lpad);
    const int Wr = plane_words<R>(Lpad);
    const int wl = window_words(R, spread_of(u)), w0 = (u.y + u.z) & ~3;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const uint32_t* own = src + (size_t)j * Wr + u.y;
        const uint32_t* win = src + (size_t)j * Wr + w0;
        uint32_t* down = buf + j * SW;
        uint32_t* dwin = buf + P * SW + j * wl;
        if (R != kBytes) {
            for (int i = 4 * threadIdx.x; i < SW; i += 4 * kThreads)
                __pipeline_memcpy_async(down + i, own + i, 16);
            for (int i = 4 * threadIdx.x; i < wl; i += 4 * kThreads)
                __pipeline_memcpy_async(dwin + i, win + i, 16);
        } else {
            for (int i = threadIdx.x; i < SW; i += kThreads) {
                if (u.y + i < Wr)
                    __pipeline_memcpy_async(down + i, own + i, 4);
                else
                    down[i] = 0u;
            }
            for (int i = threadIdx.x; i < wl; i += kThreads) {
                if (w0 + i < Wr)
                    __pipeline_memcpy_async(dwin + i, win + i, 4);
                else
                    dwin[i] = 0u;
            }
        }
    }
}

__device__ __forceinline__ void stage_unit(int4 u, const uint8_t* rows,
                                           const uint32_t* planes,
                                           uint32_t* buf, int Lpad) {
    if (dev_of(u)) return;
    switch (route_of(u)) {
        case kACGT: stage<kACGT>(u, rows, planes, buf, Lpad); break;
        case kACGTN: stage<kACGTN>(u, rows, planes, buf, Lpad); break;
        case kEscape: stage<kEscape>(u, rows, planes, buf, Lpad); break;
        default: stage<kBytes>(u, rows, planes, buf, Lpad);
    }
}

// the planes' routes: one bit a mismatching position (the planes' XORs
// folded; on route 2 every escape on either side mismatches, and pairs of
// escapes are compared apart); the byte route: bit 7 of each matching byte
template <int R>
__device__ __forceinline__ uint32_t compare(const uint32_t* a,
                                            const uint32_t* s) {
    if (R == kBytes) {
        const uint32_t x = a[0] ^ s[0];
        return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
    }
    uint32_t x = (a[0] ^ s[0]) | (a[1] ^ s[1]);
    if (R >= kACGTN) x |= a[2] ^ s[2];
    if (R == kEscape) x |= a[3] | s[3];
    return x;
}

// pairs of escapes among the 32 positions from pos0 (a multiple of 32)
// marked in `both`: equal bytes, 4 at a time
__device__ unsigned byte_matches(const uint8_t* row, int Lpad, int pos0,
                                 int lag, uint32_t both) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    const int W = Lpad >> 2, qs = (pos0 + lag) >> 2;
    const unsigned sh = (unsigned)(lag & 3) << 3;
    unsigned acc = 0;
    uint32_t lo = qs < W ? w[qs] : 0u;
    for (int j = 0; j < 8; ++j) {
        const uint32_t hi = qs + j + 1 < W ? w[qs + j + 1] : 0u;
        const uint32_t nib = (both >> (4 * j)) & 0xfu;
        if (nib) {
            const uint32_t x =
                w[(pos0 >> 2) + j] ^ __funnelshift_r(lo, hi, sh);
            const uint32_t t = (x & 0x7f7f7f7fu) + 0x7f7f7f7fu;
            // bit i of the nibble to bit 7 of byte i
            const uint32_t sel = ((nib * 0x00204081u) & 0x01010101u) << 7;
            acc += __popc(~(t | x) & 0x80808080u & sel);
        }
        lo = hi;
    }
    return acc;
}

// count a unit: its stretch and window staged in buf (kStaged) or read
// from device memory.  Lane l of each warp holds the unit's lag l in `mylag` and
// counts it over the warp's words of the stretch: its own words are the
// same for every lane (one broadcast load), its shifted words its own.
// First the words inside every lane's window (no masks), then those where
// some lane's window ends.
template <int R, bool kStaged>
__device__ __forceinline__ void count_unit(
    int4 u, int mylag, const uint8_t* __restrict__ rows,
    const int* __restrict__ lens, int* __restrict__ out,
    const uint32_t* __restrict__ planes, const uint32_t* buf, int Lpad,
    int G) {
    constexpr int P = planes_of(R), WW = words_of(R), SW = stretch_of(R);
    constexpr int PPW = ppw_of(R), SHIFT = R == kBytes ? 2 : 5;
    const int b = u.x, k0 = u.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = group_of(u) * kLG + lane;      // the lane's lag
    const int n = clip_len(lens[b], Lpad);
    const int wk = k0 + warp * WW;               // the warp's first word
    const int m = g < G && mylag >= 0 && mylag < n ? n - mylag : 0;
    const int v = max(m - wk * PPW, 0);          // the lane's valid positions
    // words every lane counts whole (a lane without a window, no lag or a
    // lag past the row, counts none and holds no one back), and words any
    // lane counts at all
    const int kA = __reduce_min_sync(0xffffffffu,
                                     m > 0 ? min(v / PPW, WW) : WW);
    const int kB = __reduce_max_sync(0xffffffffu,
                                     min((v + PPW - 1) / PPW, WW));
    if (kB == 0) return;                         // warp-uniform
    const uint8_t* row = rows + (size_t)b * Lpad;
    const uint32_t* src = plane_src<R>(rows, planes, b, Lpad);
    const int Wr = plane_words<R>(Lpad);
    const int wl = window_words(R, spread_of(u));
    // the window's first staged word lies 0-3 words below its lowest lag's
    const int qbase = ((k0 + u.z) & ~3) - k0;
    const int q = m > 0 ? mylag >> SHIFT : qbase;   // lanes without a window
    const unsigned sh = m > 0 ? (unsigned)(mylag & (PPW - 1)) * (32 / PPW)
                              : 0u;                 // read in bounds
    const int lp = wk * PPW;                     // the warp's first position
    auto own = [&](int j, int k) {
        return kStaged ? buf[j * SW + warp * WW + k]
               : wk + k < Wr ? src[(size_t)j * Wr + wk + k] : 0u;
    };
    auto shifted = [&](int j, int k) {
        return kStaged ? buf[P * SW + j * wl + (q - qbase) + warp * WW + k]
               : wk + q + k < Wr ? src[(size_t)j * Wr + wk + q + k] : 0u;
    };
    unsigned acc = 0;
    uint32_t lo[P];
#pragma unroll
    for (int j = 0; j < P; ++j) lo[j] = shifted(j, 0);
    int k = 0;
#pragma unroll 4
    for (; k < kA; ++k) {
        uint32_t a[P], t[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const uint32_t hi = shifted(j, k + 1);
            t[j] = __funnelshift_r(lo[j], hi, sh);
            lo[j] = hi;
            a[j] = own(j, k);
        }
        acc += __popc(compare<R>(a, t));
        if (R == kEscape) {
            const uint32_t both = m > 0 ? a[3] & t[3] : 0u;
            if (both) acc -= byte_matches(row, Lpad, lp + k * PPW, mylag, both);
        }
    }
    // acc so far: mismatches of whole words on the planes' routes
    if (R != kBytes) acc = (unsigned)(kA * PPW) - acc;
    for (; k < kB; ++k) {
        uint32_t a[P], t[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const uint32_t hi = shifted(j, k + 1);
            t[j] = __funnelshift_r(lo[j], hi, sh);
            lo[j] = hi;
            a[j] = own(j, k);
        }
        const int rem = v - k * PPW;
        const uint32_t mask =
            rem <= 0 ? 0u
            : R == kBytes ? (rem >= 4 ? 0xffffffffu : (1u << (8 * rem)) - 1u)
                          : (rem >= 32 ? 0xffffffffu : (1u << rem) - 1u);
        const uint32_t c = compare<R>(a, t);
        acc += __popc((R == kBytes ? c : ~c) & mask);
        if (R == kEscape) {
            const uint32_t both = a[3] & t[3] & mask;
            if (both) acc += byte_matches(row, Lpad, lp + k * PPW, mylag, both);
        }
    }
    if (m > 0 && acc) atomicAdd(&out[(size_t)b * G + g], (int)acc);
}

template <int R>
__device__ __forceinline__ void count_route(
    int4 u, int mylag, const uint8_t* __restrict__ rows,
    const int* __restrict__ lens, int* __restrict__ out,
    const uint32_t* __restrict__ planes, const uint32_t* buf, int Lpad,
    int G) {
    if (dev_of(u))
        count_unit<R, false>(u, mylag, rows, lens, out, planes, buf, Lpad, G);
    else
        count_unit<R, true>(u, mylag, rows, lens, out, planes, buf, Lpad, G);
}

__global__ void __launch_bounds__(kThreads)
    autocorr_count_kernel(const uint8_t* __restrict__ rows,
                          const int* __restrict__ lens,
                          const int* __restrict__ lags, int* __restrict__ out,
                          const int* __restrict__ hdr,
                          const int4* __restrict__ units,
                          const uint32_t* __restrict__ planes, int Lpad, int G,
                          int buf_words) {
    extern __shared__ uint32_t smem[];
    const int total = hdr[0], step = gridDim.x, lane = threadIdx.x & 31;
    int i = blockIdx.x;
    if (i >= total) return;
    // lane l of each warp holds lag l of a unit's group
    auto lag_of = [&](int4 u) {
        const int g = group_of(u) * kLG + lane;
        return g < G ? lags[g] : -1;
    };
    int4 u = units[i], un = u;
    int mylag = lag_of(u), cur = 0;
    stage_unit(u, rows, planes, smem, Lpad);
    __pipeline_commit();
    if (i + step < total) un = units[i + step];
    for (; i < total; i += step) {
        // stage the next unit while this one counts
        int nlag = -1;
        int4 unn = un;
        if (i + step < total) {
            stage_unit(un, rows, planes, smem + (cur ^ 1) * buf_words, Lpad);
            nlag = lag_of(un);
            if (i + 2 * step < total) unn = units[i + 2 * step];
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        const uint32_t* buf = smem + cur * buf_words;
        switch (route_of(u)) {
            case kACGT:
                count_route<kACGT>(u, mylag, rows, lens, out, planes, buf,
                                   Lpad, G);
                break;
            case kACGTN:
                count_route<kACGTN>(u, mylag, rows, lens, out, planes, buf,
                                    Lpad, G);
                break;
            case kEscape:
                count_route<kEscape>(u, mylag, rows, lens, out, planes, buf,
                                     Lpad, G);
                break;
            default:
                count_route<kBytes>(u, mylag, rows, lens, out, planes, buf,
                                    Lpad, G);
        }
        __syncthreads();                 // before the buffer is restaged
        u = un;
        un = unn;
        mylag = nlag;
        cur ^= 1;
    }
}

// the shared words of a count block (two buffers): kSmemWords, or what the
// card lets a block have without opting in (asked once a device)
int smem_budget() {
    static int words_of_dev[64];         // by device, 0 until asked
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
        return 0;
    if (!words_of_dev[dev]) {
        if (cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev) != cudaSuccess)
            return 0;
        optin = optin < 48 * 1024 ? optin : 48 * 1024;
        words_of_dev[dev] = (kSmemWords < optin / 4 ? kSmemWords : optin / 4)
                            & ~1;
    }
    return words_of_dev[dev];
}

// list entries a batch may need: every row's every lag group cut at the
// shortest stretch
long long unit_cap(int B, int Lpad, int G) {
    const long long NG = (G + kLG - 1) / kLG;
    const long long per = (Lpad + min_stretch_positions() - 1) /
                          min_stretch_positions();
    return (long long)B * NG * (per > 0 ? per : 1);
}

// int32 of the header and the row counters, rounded to 16 bytes
size_t counters_words(int B) { return ((size_t)kHeader + 3 * B + 3) & ~3; }

size_t planes_offset(int B, int Lpad, int G) {
    return counters_words(B) * 4 + (size_t)unit_cap(B, Lpad, G) * 16;
}

// persistent blocks of the count kernel: what the card holds at once (the
// runtime asked once a device), no more than the list may hold
int count_grid(int B, int Lpad, int G, int smem, int* per_sm) {
    static int sms_of[64], bps_of[64];   // by device, 0 until asked
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (!bps_of[dev] &&
        (cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                                dev) != cudaSuccess ||
         cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &bps_of[dev], autocorr_count_kernel, kThreads, smem) !=
             cudaSuccess))
        return 0;
    *per_sm = bps_of[dev];
    const long long cap = unit_cap(B, Lpad, G);
    const long long grid = (long long)sms_of[dev] * bps_of[dev];
    return (int)(grid < cap ? grid : cap);
}

}  // namespace

// Bytes of `scratch` for a (B, Lpad) batch and G lags: the plan's header
// (kHeader int32) and row counters (3 int32 a row), the unit list (int4
// each), the bit planes (16-byte rows) and the slack a unit's staging may
// read past the last row (a row, a stretch and 16 bytes).
extern "C" long long autocorr_scratch_bytes(int B, int Lpad, int G) {
    const long long W = plane_stride(Lpad);
    return (long long)planes_offset(B, Lpad, G) +
           ((long long)B * 4 * W + W + kWarps * kMaxWarpWords + 8) * 4;
}

// The launch geometry: geo = {count blocks, threads a count block, shared
// bytes a count block (two buffers), count blocks an SM, unit capacity,
// pack blocks, lags a unit, shared words a buffer}.
extern "C" int autocorr_geometry(int B, int Lpad, int G, int* geo) {
    const int budget = smem_budget();
    int per_sm = 0;
    geo[0] = count_grid(B, Lpad, G, budget * 4, &per_sm);
    geo[1] = kThreads;
    geo[2] = budget * 4;
    geo[3] = per_sm;
    const long long cap = unit_cap(B, Lpad, G);
    geo[4] = cap < INT_MAX ? (int)cap : INT_MAX;
    geo[5] = B * ((Lpad + kChunk - 1) / kChunk > 0
                      ? (Lpad + kChunk - 1) / kChunk : 1);
    geo[6] = kLG;
    geo[7] = budget / 2;
    return cudaSuccess;
}

// out (B, G) int32 <- the match counts of rows (B, Lpad) uint8 with lens
// (B,) int32 at lags (G,) int32, on `stream`: the counters' memset, the
// pack kernel, the count kernel.  Lpad % 4 == 0 and rows 4-byte aligned;
// scratch of autocorr_scratch_bytes(B, Lpad, G) bytes, 16-byte aligned.
// After the launch the header reads: [0] units, [1 + r] rows of route r,
// [5] units read from device memory, [6] lags a unit, [7] the int32 where
// the unit list starts, [8 + r] positions a stretch of route r.
extern "C" int autocorr_launch(const uint8_t* rows, const int* lens,
                               const int* lags, int* out, void* scratch,
                               int B, int Lpad, int G, cudaStream_t stream) {
    if (B < 0 || G < 0 || Lpad < 0 || Lpad % 4 != 0 ||
        reinterpret_cast<uintptr_t>(rows) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
        return cudaErrorInvalidValue;
    if (B == 0 || G == 0) return cudaSuccess;
    const long long chunks = Lpad > 0 ? (Lpad + kChunk - 1) / kChunk : 1;
    if ((G + kLG - 1) / kLG > kMaxGroups || unit_cap(B, Lpad, G) > INT_MAX ||
        (long long)B * chunks > INT_MAX)
        return cudaErrorInvalidValue;
    int* hdr = static_cast<int*>(scratch);
    int* rowc = hdr + kHeader;
    int4* units = reinterpret_cast<int4*>(hdr + counters_words(B));
    uint32_t* planes = reinterpret_cast<uint32_t*>(
        static_cast<char*>(scratch) + planes_offset(B, Lpad, G));
    const int budget = smem_budget();
    int per_sm = 0;
    const int grid = count_grid(B, Lpad, G, budget * 4, &per_sm);
    if (grid <= 0) return cudaErrorInvalidValue;
    cudaError_t err = (cudaError_t)cudaMemsetAsync(
        hdr, 0, (kHeader + 3 * (size_t)B) * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    autocorr_pack_kernel<<<(unsigned)(B * chunks), kPackThreads, 0, stream>>>(
        rows, lens, lags, out, hdr, rowc, units, planes, Lpad, G, (int)chunks,
        budget / 2);
    err = (cudaError_t)cudaGetLastError();
    if (err != cudaSuccess) return err;
    autocorr_count_kernel<<<grid, kThreads, budget * 4, stream>>>(
        rows, lens, lags, out, hdr, units, planes, Lpad, G, budget / 2);
    return cudaGetLastError();
}
