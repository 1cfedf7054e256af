"""The port's split-stage MinHash (smoothxg_tpu_torch/ops/minhash_cuda.py)
against the JAX package's (smoothxg_tpu/ops/minhash_jax.py): distance
matrices bit-identical to JAX DeviceMinHash on the CPU and to the port's
numpy mirror, on seeded blocks of related and unrelated sequences, with
masks, short and non-ACGT sequences, and the one canonical 16-mer whose
hash is the 0xFFFFFFFF sentinel (ROADMAP C2: the JAX function drops it,
the JAX mirror keeps it, the port drops it everywhere); and csrc/
minhash.cu's two entries compiled against the CUDA emulation, equal to
their plain versions."""
import numpy as np
import pytest
import torch

from smoothxg_tpu.ops import minhash_jax
from smoothxg_tpu_torch.ops import minhash_cuda as mc
from smoothxg_tpu_torch.testing import cuda_emu


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(rng, s, p):
    out = list(s)
    for i in np.flatnonzero(rng.random(len(out)) < p):
        out[i] = "ACGT"[(("ACGT".index(out[i])) + 1) % 4]
    return "".join(out)


def make_block(seed: int, n: int = 14):
    """Related sequences (mutated copies of one), unrelated ones, short
    ones, one with non-ACGT bases and lower case, and the sentinel k-mer."""
    rng = np.random.default_rng(seed)
    base = _seq(rng, int(rng.integers(200, 700)))
    seqs = [_mutate(rng, base, p) for p in rng.choice([0.0, 0.02, 0.1],
                                                      n // 2)]
    seqs += [_seq(rng, int(rng.integers(0, 400))) for _ in range(n // 4)]
    seqs += ["ACG", base[:300].lower() + "NNNN" + base[300:]]
    seqs.append(base[:100] + mc.SENTINEL_KMER + base[100:])
    return seqs


def test_sentinel_kmer_hashes_to_the_sentinel():
    """fmix32 is a bijection: exactly one 32-bit value hashes to
    0xFFFFFFFF, and it is the pack of a canonical 16-mer, so k = 16 (the
    pipeline's default) reaches it."""
    v = mc._unfmix32(0xFFFFFFFF)
    assert int(mc._fmix32_np(np.array([v]))[0]) == 0xFFFFFFFF
    assert mc._kmer_of(v, 16) == mc.SENTINEL_KMER
    jax_h = minhash_jax.kmer_hashes32(mc.SENTINEL_KMER, 16)
    assert jax_h.tolist() == [0xFFFFFFFF]          # the JAX mirror keeps it
    assert len(mc.kmer_hashes32(mc.SENTINEL_KMER, 16)) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distances_bit_identical_to_jax_and_mirror(seed):
    seqs = make_block(seed)
    mask = np.array([len(s) >= 50 for s in seqs])
    for m in (None, mask):
        mine = mc.DeviceMinHash(16, device="cpu").distance_matrix(seqs, m)
        jax_dev = minhash_jax.DeviceMinHash(16).distance_matrix(seqs, m)
        assert np.array_equal(mine.view(np.int64), jax_dev.view(np.int64))
        mirror = mc.host_distance_matrix(seqs, 16, m)
        assert np.array_equal(mine.view(np.int64), mirror.view(np.int64))
    assert (mine < 0.5).sum() > len(seqs)          # related pairs are close


def test_sentinel_pair_differs_from_the_jax_mirror_only():
    """On the planted sentinel k-mer the JAX device function and the JAX
    mirror disagree; the port agrees with the device function."""
    seqs = make_block(3)
    jax_mirror = minhash_jax.host_distance_matrix(seqs, 16)
    mine = mc.DeviceMinHash(16, device="cpu").distance_matrix(seqs)
    assert np.array_equal(mine, minhash_jax.DeviceMinHash(16)
                          .distance_matrix(seqs))
    diff = np.argwhere(mine != jax_mirror)
    assert len(diff) and set(diff.ravel()) >= {len(seqs) - 1}


def test_other_k():
    seqs = make_block(4, 8)
    for k in (5, 11):
        mine = mc.DeviceMinHash(k, device="cpu").distance_matrix(seqs)
        assert np.array_equal(mine, minhash_jax.DeviceMinHash(k)
                              .distance_matrix(seqs))


def _long_block(seed: int = 11, n: int = 50_000):
    """A row past the hash kernel's shared-memory route (~46k codes at k
    16), a mutated copy, a ~20k prefix and a short row."""
    rng = np.random.default_rng(seed)
    big = _seq(rng, n)
    return [big, _mutate(rng, big, 0.01), big[:20_000], "ACGTACGTACGTACGTA",
            _mutate(rng, big[5_000:25_000], 0.02)]


def _hash_rows_against_jax(seqs, k):
    codes, lens = mc.encode_batch(seqs)
    B, L = codes.shape
    hashes_fn, _ = minhash_jax._compiled(k, B, L, 128)
    jax_hs, jax_counts = (np.asarray(v) for v in hashes_fn(codes, lens))
    hs, counts = mc.minhash_hash(torch.from_numpy(codes),
                                 torch.from_numpy(lens), k)
    assert hs.dtype == torch.int32
    assert np.array_equal(counts.numpy(), jax_counts)
    back = (hs.numpy().astype(np.int64) + 2 ** 31).astype(np.uint32)
    assert np.array_equal(back, jax_hs)
    assert int(hs[0, -1]) == mc.SENTINEL_KEY


@pytest.mark.parametrize("k", [16, 9])
def test_hash_rows_equal_the_jax_function(k):
    """The int32 sort keys, read back as uint32 (key + 2^31), are JAX
    hashes_fn's sorted unique rows and counts: signed key order is the
    hashes' unsigned order, and the sentinel pads after the uniques."""
    _hash_rows_against_jax(make_block(7), k)


def test_hash_rows_equal_the_jax_function_past_shared_memory():
    """The same for a batch of rows past the hash kernel's shared-memory
    route (the rows `minhash_hash` hands to `minhash_hash_long`)."""
    seqs = _long_block()
    assert mc.hash_smem(max(map(len, seqs)), 16) > mc.SMEM_MAX
    _hash_rows_against_jax(seqs, 16)


def test_long_rows_distances_equal_the_jax_function():
    """Distances of a block with rows of 20k-50k bases (past both kernels'
    shared-memory routes) equal JAX DeviceMinHash's and the mirror's."""
    seqs = _long_block()
    mine = mc.DeviceMinHash(16, device="cpu").distance_matrix(seqs)
    jax_dev = minhash_jax.DeviceMinHash(16).distance_matrix(seqs)
    assert np.array_equal(mine.view(np.int64), jax_dev.view(np.int64))
    mirror = mc.host_distance_matrix(seqs, 16)
    assert np.array_equal(mine.view(np.int64), mirror.view(np.int64))


@pytest.fixture(scope="module")
def emu_exe(tmp_path_factory):
    return cuda_emu.build("minhash", str(tmp_path_factory.mktemp("minhash")
                                         / "minhash"))


def test_kernels_emulated_match_plain_versions(emu_exe):
    """Both entries on the seeded blocks, each route, against the plain
    versions: sorted_sets(minhash_hash_reference) and
    minhash_inter_reference over np.triu_indices."""
    for seed in (5, 6):
        seqs = make_block(seed)
        codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
        for k in (16, 7):
            want = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, k))
            for device_keys in (False, True):
                got = cuda_emu.run_minhash_hash(emu_exe, codes, lens, k,
                                                device_keys)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
            hs, counts = want
            ref = mc.minhash_inter_reference(
                hs, counts, *mc.triu_pairs(len(seqs)))
            # the long route (a block a pair) on the first block
            for rows in (mc.tile_rows(*hs.shape), 0)[:2 if seed == 5 else 1]:
                inter = cuda_emu.run_minhash_inter(emu_exe, hs, counts, rows)
                assert torch.equal(inter, ref)
            assert torch.equal(mc.minhash_inter(hs, counts), ref)
            assert int(ref.max()) > 100


def _case(name: str):
    """(seqs, k) of an edge case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    base = _seq(rng, 600)
    if name == "k16" or name == "k11":
        return [_mutate(rng, base, p) for p in (0.0, 0.02, 0.1)] + [
            _seq(rng, 300)], int(name[1:])
    if name == "sentinel":
        return [base[:50] + mc.SENTINEL_KMER + base[50:],
                mc.SENTINEL_KMER, base], 16
    if name == "shorter_than_k":
        return ["ACGTACGTAC", base, "A" * 15], 16
    if name == "all_n":
        return ["N" * 700, base, "n" * 20 + "ACGT"], 16
    if name == "b2":
        return [base, _mutate(rng, base, 0.05)], 16
    if name == "uneven":          # rows of 1 and ~20k hashes
        big = _seq(rng, 20_000)
        return ["A" * 16, big, _mutate(rng, big, 0.01), "A" * 17], 16
    raise KeyError(name)


HASH_CASES = ["k16", "k11", "sentinel", "shorter_than_k", "all_n", "b2",
              "uneven"]


@pytest.mark.parametrize("device_keys", [False, True])
@pytest.mark.parametrize("name", HASH_CASES)
def test_hash_kernel_emulated_edge_cases(emu_exe, name, device_keys):
    seqs, k = _case(name)
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    hs, counts = cuda_emu.run_minhash_hash(emu_exe, codes, lens, k,
                                           device_keys)
    want = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, k))
    assert torch.equal(hs, want[0]) and torch.equal(counts, want[1])
    if name == "shorter_than_k":
        assert counts.tolist()[::2] == [0, 0]
    if name == "all_n":
        assert counts[0] == 0 and (hs[0] == mc.SENTINEL_KEY).all()
    if name == "sentinel":         # the sentinel 16-mer is dropped
        assert counts[1] == 0
    if name == "uneven":
        assert counts[0] == 1 and counts[1] > 19_000


def test_hash_kernel_emulated_past_shared_memory(emu_exe):
    """A 50k row: the shared-memory route refuses it, the device-memory
    route sorts it in its output row."""
    seqs = _long_block()
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    with pytest.raises(RuntimeError, match="emulated launch failed"):
        cuda_emu.run_minhash_hash(emu_exe, codes, lens, 16, False)
    hs, counts = cuda_emu.run_minhash_hash(emu_exe, codes, lens, 16, True,
                                           timeout=300)
    want = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, 16))
    assert torch.equal(hs, want[0]) and torch.equal(counts, want[1])
    assert int(counts.max()) > 40_000


@pytest.mark.parametrize("name,rows", [
    ("k16", 1), ("k16", 3), ("k11", 4), ("sentinel", 2), ("all_n", 2),
    ("b2", 1), ("b2", 2), ("k11", 3), ("uneven", 1), ("uneven", 0),
    ("shorter_than_k", 0)])
def test_inter_kernel_emulated_edge_cases(emu_exe, name, rows):
    """Tiles of `rows` rows (B not a multiple of the tile where rows does
    not divide B) or the long route (rows 0)."""
    seqs, k = _case(name)
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    hs, counts = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, k))
    got = cuda_emu.run_minhash_inter(emu_exe, hs, counts, rows)
    assert torch.equal(got, mc.minhash_inter_reference(
        hs, counts, *mc.triu_pairs(len(seqs))))


def test_inter_kernel_emulated_long_rows(emu_exe):
    """Rows of 20k-50k hashes (past a tile) merged in staged segments."""
    seqs = _long_block()
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    hs, counts = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, 16))
    assert mc.tile_rows(*hs.shape) == 0 and int(counts.max()) >= 40_000
    got = cuda_emu.run_minhash_inter(emu_exe, hs, counts, 0, timeout=300)
    assert torch.equal(got, mc.minhash_inter_reference(
        hs, counts, *mc.triu_pairs(len(seqs))))


def test_inter_kernel_emulated_many_rows(emu_exe):
    """40 rows at the default tile (B not a multiple of it) and at tiles
    of 7 rows, against the plain version."""
    rng = np.random.default_rng(21)
    base = _seq(rng, 400)
    seqs = [_mutate(rng, base, float(p)) for p in rng.choice(
        [0.0, 0.01, 0.05, 0.2], 40)]
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    hs, counts = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, 16))
    ref = mc.minhash_inter_reference(hs, counts, *mc.triu_pairs(40))
    assert mc.tile_rows(*hs.shape) == 32
    for rows in (32, 7):
        assert torch.equal(cuda_emu.run_minhash_inter(emu_exe, hs, counts,
                                                      rows), ref)


def test_routes_by_row_length():
    """The pipeline's blocks (2-8 rows of <= ~1,100 codes) are one tile;
    the deep timing block takes tiles of 9 rows; rows past ~28.9k hashes
    take the long intersection route, past ~46k codes the long hash
    route."""
    assert [mc.tile_rows(B, 700) for B in (2, 8)] == [2, 8]
    assert mc.tile_rows(8, 1100) == 8
    assert mc.tile_rows(512, 1452) == 9
    assert mc.tile_rows(2, 28_900) == 1 and mc.tile_rows(2, 29_000) == 0
    assert mc.hash_smem(46_000, 16) <= mc.SMEM_MAX < mc.hash_smem(47_000, 16)


@pytest.mark.parametrize("seed", [0, 8])
def test_vector_distances_equal_the_scalar_function(seed):
    """mash_distances over every pair of a seeded block (identical rows,
    empty rows and the sentinel included) equals mash_distance_from_counts
    pair by pair, bit for bit."""
    seqs = make_block(seed, 24) + make_block(seed, 6)[:3]
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    hs, counts = mc.minhash_hash(codes, lens, 16)
    ii, jj = np.triu_indices(len(seqs), 1)
    inter = mc.minhash_inter(hs, counts).numpy()
    c = counts.numpy()
    got = mc.mash_distances(inter, c[ii], c[jj], 16)
    want = np.array([mc.mash_distance_from_counts(int(n), int(c[a]),
                                                  int(c[b]), 16)
                     for n, a, b in zip(inter, ii, jj)])
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert (want == 0).any() and (want == 1).any()


def test_wrappers_check_their_inputs(monkeypatch):
    codes = torch.zeros((2, 5), dtype=torch.int8)
    with pytest.raises(ValueError):
        mc.minhash_hash(codes, torch.zeros(2, dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        mc.minhash_hash(codes, torch.zeros(2, dtype=torch.int32), 17)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        mc.DeviceMinHash(16)
