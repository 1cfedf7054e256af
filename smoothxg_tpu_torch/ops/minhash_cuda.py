"""Batched MinHash on the GPU: canonical k-mer hashing and all-pairs mash
distances over a block's sequences (the split stage's
`--device-split-minhash` route).

Port of smoothxg_tpu/ops/minhash_jax.py (reference: rkmh::hash_sequences +
rkmh::compare, src/breaks.cpp:378-464).  For k <= 16 a canonical k-mer
fits 32 bits, so the hash space is uint32 (murmur3's fmix32); hashes travel
as int32 sort keys `h ^ 0x80000000`, so that signed order is the hashes'
unsigned order.  The kernels (csrc/minhash.cu) are `minhash_hash` (the
whole of hashes_fn, a block a row: rolling canonical k-mers, fmix32, a
sort, dedup and compaction in shared memory; `minhash_hash_long` sorts in
device memory the rows too long for it) and `minhash_inter` (|A ∩ B| of
every pair, a block a tile of rows staged in shared memory, each pair's
merge path cut into stretches, a thread a stretch; `minhash_inter_long`, a
block a pair in staged segments, takes rows too long for a tile);
`minhash_hash` and `minhash_inter` hand such rows to them by row length
alone.  CPU tensors run the plain versions,
`sorted_sets(minhash_hash_reference(...))` and `minhash_inter_reference`
(the JAX function's sort of each pair's concatenation).  The distances are
computed on the host in float64 from the integer counts, so every route
gives the same bits.

The sentinel (ROADMAP C2): the JAX function drops a valid k-mer whose hash
is 0xFFFFFFFF with the padding, and its numpy mirror kept it.  fmix32 is a
bijection, so exactly one 32-bit value hashes to the sentinel: the pack
of the canonical 16-mer `SENTINEL_KMER` (as a 15-mer it is not canonical,
and it exceeds every shorter k-mer's range).  The pipeline's k (min(16,
-k), 16 by default) reaches it.  The port follows the JAX function on
every route, the mirror copy here (`kmer_hashes32`) included.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = np.uint32(0xFFFFFFFF)
SENTINEL_KEY = 0x7FFFFFFF   # the sentinel's sort key, the largest int32
_BASE_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _BASE_CODE[ord(_c)] = _i
    _BASE_CODE[ord(_c.lower())] = _i


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer (numpy mirror of the device math)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def _unfmix32(h: int) -> int:
    """The 32-bit value fmix32 maps to h (fmix32 inverted step by step)."""
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 1 << 32)) & m
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 1 << 32)) & m
    h ^= h >> 16
    return h


def _kmer_of(v: int, k: int) -> str:
    """The k-mer whose forward 2-bit pack is v."""
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


# the one canonical k-mer (k = 16) whose hash is the sentinel
SENTINEL_KMER = _kmer_of(_unfmix32(0xFFFFFFFF), 16)


def kmer_hashes32(seq: str | bytes, k: int) -> np.ndarray:
    """Host mirror: sorted unique uint32 hashes of canonical k-mers
    (k <= 16), without the sentinel value.  Bit-identical to the device
    route's per-row hash set."""
    assert k <= 16, "uint32 canonical k-mers need k <= 16"
    if isinstance(seq, str):
        seq = seq.encode()
    arr = _BASE_CODE[np.frombuffer(bytes(seq), dtype=np.uint8)]
    n = len(arr) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    codes = arr.astype(np.int64)
    fwd = np.zeros(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    for i in range(k):
        fwd = (fwd << 2) | (codes[i:i + n] & 3)
        rev = rev | ((3 ^ (codes[i:i + n] & 3)) << (2 * i))
        ok &= codes[i:i + n] >= 0
    canon = np.minimum(fwd, rev).astype(np.uint32)
    h = np.unique(_fmix32_np(canon[ok]))
    return h[h != SENTINEL]


def mash_distance_from_counts(inter: int, ca: int, cb: int, k: int) -> float:
    """Mash distance from integer (intersection, set sizes) — float64 on
    host, shared by the device route and the host mirror."""
    if ca == 0 or cb == 0 or inter == 0:
        return 1.0
    j = inter / (ca + cb - inter)
    d = -np.log(2.0 * j / (1.0 + j)) / k
    return float(min(max(d, 0.0), 1.0))


def encode_batch(seqs: list[bytes | str], L: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pack sequences to a [B, L] int8 code batch (-1 = pad/invalid)."""
    bs = [s.encode() if isinstance(s, str) else bytes(s) for s in seqs]
    if L is None:
        L = max((len(s) for s in bs), default=1)
    out = np.full((len(bs), max(L, 1)), -1, dtype=np.int8)
    for i, s in enumerate(bs):
        out[i, :len(s)] = _BASE_CODE[np.frombuffer(s, dtype=np.uint8)]
    lens = np.array([len(s) for s in bs], dtype=np.int32)
    return out, lens


def host_distance_matrix(seqs: list[bytes | str], k: int = 16,
                         mask: np.ndarray | None = None) -> np.ndarray:
    """Numpy mirror of DeviceMinHash.distance_matrix — the parity oracle."""
    n = len(seqs)
    out = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(out, 0.0)
    el = np.ones(n, dtype=bool) if mask is None else np.asarray(mask)
    idx = np.nonzero(el)[0]
    hs = {int(i): kmer_hashes32(seqs[i], k) for i in idx}
    for a in range(len(idx)):
        for b in range(a + 1, len(idx)):
            i, j = int(idx[a]), int(idx[b])
            inter = len(np.intersect1d(hs[i], hs[j], assume_unique=True))
            d = mash_distance_from_counts(inter, len(hs[i]), len(hs[j]), k)
            out[i, j] = out[j, i] = d
    return out


# ---------------------------------------------------------------------------
# the kernels' wrappers and their plain versions
# ---------------------------------------------------------------------------

# dynamic shared memory a block of csrc/minhash.cu may take (minhash.cu:
# SMEM_MAX), and the share a tile of minhash_inter takes so that two blocks
# fit an SM (228 KB an SM less 1 KB a block, halved)
SMEM_MAX = 232448 - 1024
TILE_SMEM = 115712
TILE_ROWS_MAX = 32


def hash_smem(L: int, k: int) -> int:
    """Shared bytes of minhash_hash on a (B, L) batch: 4 B a k-mer start
    position and 1 B a code."""
    return 4 * max(L - (k - 1), 0) + L


def tile_smem(R: int, H: int) -> int:
    """Shared bytes of a minhash_inter tile of R rows of stride H: 2 R slots
    of round_up(H + 1, 4) int32 words and the pairs' matches (R R)."""
    return 4 * (2 * R * ((H + 4) // 4 * 4) + R * R)


def tile_rows(B: int, H: int) -> int:
    """Rows R of a minhash_inter tile for B rows of stride H: the most, up
    to 32 and B, whose tile fits TILE_SMEM; else 1 where a tile of one row
    a side fits SMEM_MAX; else 0: the long route, a block a pair."""
    R = min(TILE_ROWS_MAX, B)
    while R > 1 and tile_smem(R, H) > TILE_SMEM:
        R -= 1
    return R if tile_smem(R, H) <= SMEM_MAX else 0


def _fmix32_t(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 tensors holding uint32 values."""
    m = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & m
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def hash_keys(h: torch.Tensor) -> torch.Tensor:
    """int32 sort keys of uint32 hashes held in int64: h ^ 0x80000000
    read as signed, which is h - 2^31."""
    return (h - 0x80000000).to(torch.int32)


def minhash_hash_reference(codes: torch.Tensor, lens: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Per-position hash keys, the first half of hashes_fn: (B, L) int32
    sort keys (`hash_keys`) of the hash of the canonical k-mer starting at
    each position or of the sentinel (smoothxg_tpu/ops/minhash_jax.py:
    107-128).  `sorted_sets` of it is the plain version of the kernels
    `minhash_hash` and `minhash_hash_long`."""
    B, L = codes.shape
    c = codes.to(torch.int64)
    fwd = torch.zeros((B, L), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    ok = torch.ones((B, L), dtype=torch.bool, device=codes.device)
    for i in range(k):
        ci = torch.roll(c, -i, dims=1)
        fwd = ((fwd << 2) | (ci & 3)) & 0xFFFFFFFF
        rev = rev | ((3 ^ (ci & 3)) << (2 * i))
        ok = ok & (ci >= 0)
    pos = torch.arange(L, device=codes.device)[None, :]
    ok = ok & (pos < (lens.to(torch.int64)[:, None] - (k - 1)))
    h = _fmix32_t(torch.minimum(fwd, rev))
    return hash_keys(torch.where(ok, h, torch.full_like(h, int(SENTINEL))))


def sorted_sets(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's unique non-sentinel hash keys, sorted, then sentinel
    padding; and their counts (int32): hashes_fn's two sorts and dedup
    (minhash_jax.py:129-136), as torch.sort calls."""
    hs = torch.sort(h, dim=1).values
    first = torch.ones_like(hs, dtype=torch.bool)
    first[:, 1:] = hs[:, 1:] != hs[:, :-1]
    uniq = first & (hs != SENTINEL_KEY)
    hs = torch.where(uniq, hs, torch.full_like(hs, SENTINEL_KEY))
    return torch.sort(hs, dim=1).values, uniq.sum(1, dtype=torch.int32)


def _plain_hash(codes, lens, k, counts):
    hs, c = sorted_sets(minhash_hash_reference(codes, lens, k))
    if counts is None:
        return hs, c
    return hs, counts.copy_(c)


def _check_codes(codes: torch.Tensor, lens: torch.Tensor, k: int) -> None:
    if codes.dtype != torch.int8 or codes.dim() != 2 or \
            lens.dtype != torch.int32 or lens.shape != codes.shape[:1] or \
            lens.device != codes.device or not codes.is_contiguous() or \
            not lens.is_contiguous():
        raise ValueError("minhash_hash wants (B, L) int8 codes and (B,) "
                         "int32 lengths on one device")
    if not 1 <= k <= 16:
        raise ValueError(f"uint32 canonical k-mers need 1 <= k <= 16: {k}")


def _hash_launch(codes, lens, k, device_keys, counts):
    B, L = codes.shape
    hs = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    if counts is None:
        counts = torch.empty(B, dtype=torch.int32, device=codes.device)
    elif counts.dtype != torch.int32 or counts.shape != (B,) or \
            counts.device != codes.device or not counts.is_contiguous():
        raise ValueError("counts must be a (B,) int32 tensor beside codes")
    _launch("minhash_hash", codes, codes.data_ptr(), lens.data_ptr(),
            hs.data_ptr(), counts.data_ptr(), B, L, k, int(device_keys))
    return hs, counts


def minhash_hash(codes: torch.Tensor, lens: torch.Tensor, k: int,
                 counts: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """hashes_fn of a (B, L) int8 code batch with int32 row lengths: (B, L)
    int32 sorted unique hash key rows with sentinel padding, and (B,) int32
    counts (written into `counts` where given).  CUDA tensors launch
    csrc/minhash.cu's shared-memory route (and raise on a launch error);
    rows whose keys and codes exceed it (`hash_smem(L, k)` > SMEM_MAX) go
    to `minhash_hash_long`, by their length alone.  CPU tensors run
    `sorted_sets(minhash_hash_reference(...))`."""
    _check_codes(codes, lens, k)
    if codes.device.type == "cpu":
        return _plain_hash(codes, lens, k, counts)
    if hash_smem(codes.shape[1], k) > SMEM_MAX:
        return minhash_hash_long(codes, lens, k, counts)
    out = _hash_launch(codes, lens, k, False, counts)
    minhash_hash.launches += 1
    return out


minhash_hash.launches = 0     # kernel launches made by this wrapper


def minhash_hash_long(codes: torch.Tensor, lens: torch.Tensor, k: int,
                      counts: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`minhash_hash` with each row's keys sorted in its output row in
    device memory: rows of any length.  CPU tensors run the plain
    version."""
    _check_codes(codes, lens, k)
    if codes.device.type == "cpu":
        return _plain_hash(codes, lens, k, counts)
    out = _hash_launch(codes, lens, k, True, counts)
    minhash_hash_long.launches += 1
    return out


minhash_hash_long.launches = 0


def triu_pairs(B: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """np.triu_indices(B, 1) as two int32 tensors."""
    ii, jj = np.triu_indices(B, 1)
    return (torch.from_numpy(ii.astype(np.int32)).to(device),
            torch.from_numpy(jj.astype(np.int32)).to(device))


def minhash_inter_reference(hs: torch.Tensor, counts: torch.Tensor,
                            pa: torch.Tensor, pb: torch.Tensor,
                            chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of minhash_inter: the number of equal
    neighbours (not the sentinel) in each pair's sorted concatenation
    (inter_fn, minhash_jax.py:139-146) for the row pairs (pa[t], pb[t]).
    (P,) int32."""
    out = torch.empty(pa.numel(), dtype=torch.int32, device=hs.device)
    for s in range(0, pa.numel(), chunk):
        a, b = hs[pa[s:s + chunk].long()], hs[pb[s:s + chunk].long()]
        m = torch.sort(torch.cat([a, b], dim=1), dim=1).values
        eq = (m[:, 1:] == m[:, :-1]) & (m[:, 1:] != SENTINEL_KEY)
        out[s:s + chunk] = eq.sum(1, dtype=torch.int32)
    return out


def _plain_inter(hs, counts, out):
    got = minhash_inter_reference(hs, counts, *triu_pairs(hs.shape[0]))
    return got if out is None else out.copy_(got)


def _inter_launch(hs, counts, R, out):
    B, H = hs.shape
    P = B * (B - 1) // 2
    if out is None:
        out = torch.empty(P, dtype=torch.int32, device=hs.device)
    elif out.dtype != torch.int32 or out.shape != (P,) or \
            out.device != hs.device or not out.is_contiguous():
        raise ValueError("out must be a (B (B - 1) / 2,) int32 tensor "
                         "beside hs")
    _launch("minhash_inter", hs, hs.data_ptr(), counts.data_ptr(),
            out.data_ptr(), B, H, R)
    return out


def _check_rows(hs: torch.Tensor, counts: torch.Tensor) -> None:
    if hs.dtype != torch.int32 or hs.dim() != 2 or not hs.is_contiguous() \
            or counts.dtype != torch.int32 or counts.shape != hs.shape[:1] \
            or not counts.is_contiguous() or counts.device != hs.device:
        raise ValueError("minhash_inter wants (B, H) int32 rows and (B,) "
                         "int32 counts on one device")


def minhash_inter(hs: torch.Tensor, counts: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """|A ∩ B| of every pair a < b of `minhash_hash`'s rows, (B (B - 1) /
    2,) int32 in np.triu_indices order (written into `out` where given).
    CUDA tensors launch csrc/minhash.cu's tile kernel with tiles of
    `tile_rows(B, H)` rows (and raise on a launch error); rows too long for
    a tile (`tile_rows` 0) go to `minhash_inter_long`, by their length
    alone.  CPU tensors run `minhash_inter_reference` on the triangle's
    pairs."""
    _check_rows(hs, counts)
    if hs.device.type == "cpu":
        return _plain_inter(hs, counts, out)
    R = tile_rows(*hs.shape)
    if R == 0:
        return minhash_inter_long(hs, counts, out)
    res = _inter_launch(hs, counts, R, out)
    minhash_inter.launches += 1
    return res


minhash_inter.launches = 0    # kernel launches made by this wrapper


def minhash_inter_long(hs: torch.Tensor, counts: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """`minhash_inter` as a block a pair, its merge staged in segments:
    rows of any length.  CPU tensors run the plain version."""
    _check_rows(hs, counts)
    if hs.device.type == "cpu":
        return _plain_inter(hs, counts, out)
    res = _inter_launch(hs, counts, 0, out)
    minhash_inter_long.launches += 1
    return res


minhash_inter_long.launches = 0


def _launch(name: str, like: torch.Tensor, *args) -> None:
    """lib.<name>_launch(*args, stream) on `like`'s CUDA device; raises on
    a launch error."""
    if like.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {like.device}")
    from . import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(like.device).cuda_stream
    with torch.cuda.device(like.device):
        rc = getattr(lib, f"{name}_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.poa_win_error_string(rc).decode()})")


def mash_distances(inter: np.ndarray, ca: np.ndarray, cb: np.ndarray,
                   k: int) -> np.ndarray:
    """`mash_distance_from_counts` over arrays at once: the same float64
    operations in the same order, so the same bits."""
    inter, ca, cb = (np.asarray(v, dtype=np.int64) for v in (inter, ca, cb))
    live = (ca != 0) & (cb != 0) & (inter != 0)
    j = np.divide(inter, ca + cb - inter, out=np.ones(len(inter)),
                  where=live)
    d = -np.log(2.0 * j / (1.0 + j)) / k
    d = np.where(0.0 > d, 0.0, d)           # max(d, 0.0), -0.0 kept
    d = np.where(1.0 < d, 1.0, d)           # min(d, 1.0)
    return np.where(live, d, 1.0)


class DeviceMinHash:
    """All-pairs mash-distance matrix for one block's sequences on
    `device` ("cuda": the kernels; "cpu": their plain versions); distances
    bit-identical to the kmer_hashes32 mirror."""

    def __init__(self, k: int = 16, device: str | torch.device = "cuda"):
        from ..device import resolve
        assert k <= 16
        self.k = k
        self.device = resolve(
            device, what="--device-split-minhash runs its MinHash kernels "
            "(csrc/minhash.cu) on an NVIDIA GPU",
            instead="leave the flag off for the host route")

    def distance_matrix(self, seqs: list[bytes | str],
                        mask: np.ndarray | None = None) -> np.ndarray:
        """[n, n] float64 mash distances (diagonal 0).  mask: boolean
        per-seq eligibility; ineligible rows/cols stay 1.0.  One copy to
        the device (lengths and codes packed), one launch of each step,
        one copy back (counts and intersections)."""
        n = len(seqs)
        out = np.ones((n, n), dtype=np.float64)
        np.fill_diagonal(out, 0.0)
        if n < 2:
            return out
        el = np.ones(n, dtype=bool) if mask is None else np.asarray(mask)
        idx = np.nonzero(el)[0]
        if len(idx) < 2:
            return out
        codes, lens = encode_batch([seqs[i] for i in idx])
        B, L = codes.shape
        packed = np.empty(4 * B + B * L, dtype=np.int8)
        packed[:4 * B] = lens.view(np.int8)
        packed[4 * B:] = codes.ravel()
        dev = torch.from_numpy(packed).to(self.device)
        P = B * (B - 1) // 2
        res = torch.empty(B + P, dtype=torch.int32, device=self.device)
        hs, counts = minhash_hash(dev[4 * B:].view(B, L),
                                  dev[:4 * B].view(torch.int32), self.k,
                                  counts=res[:B])
        minhash_inter(hs, counts, out=res[B:])
        res = res.cpu().numpy()
        counts, inters = res[:B], res[B:]
        ii, jj = np.triu_indices(B, 1)
        d = mash_distances(inters, counts[ii], counts[jj], self.k)
        out[idx[ii], idx[jj]] = d
        out[idx[jj], idx[ii]] = d
        return out
