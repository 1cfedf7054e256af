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


@pytest.mark.parametrize("k", [16, 9])
def test_hash_rows_equal_the_jax_function(k):
    """The int32 sort keys, read back as uint32 (key + 2^31), are JAX
    hashes_fn's sorted unique rows and counts: signed key order is the
    hashes' unsigned order, and the sentinel pads after the uniques."""
    seqs = make_block(7)
    codes, lens = mc.encode_batch(seqs)
    B, L = codes.shape
    hashes_fn, _ = minhash_jax._compiled(k, B, L, 128)
    jax_hs, jax_counts = (np.asarray(v) for v in hashes_fn(codes, lens))
    hs, counts = mc.minhash_hashes(torch.from_numpy(codes),
                                   torch.from_numpy(lens), k)
    assert hs.dtype == torch.int32
    assert np.array_equal(counts.numpy(), jax_counts)
    back = (hs.numpy().astype(np.int64) + 2 ** 31).astype(np.uint32)
    assert np.array_equal(back, jax_hs)
    assert int(hs[0, -1]) == mc.SENTINEL_KEY


def test_kernels_emulated_match_plain_versions(tmp_path):
    exe = cuda_emu.build("minhash", str(tmp_path / "minhash"))
    for seed in (5, 6):
        seqs = make_block(seed)
        codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
        for k in (16, 7):
            h = cuda_emu.run_minhash_hash(exe, codes, lens, k)
            assert torch.equal(h, mc.minhash_hash(codes, lens, k))
            hs, counts = mc.sorted_sets(h)
            ii, jj = np.triu_indices(len(seqs), 1)
            pa = torch.from_numpy(ii.astype(np.int32))
            pb = torch.from_numpy(jj.astype(np.int32))
            inter = cuda_emu.run_minhash_inter(exe, hs, counts, pa, pb)
            assert torch.equal(inter, mc.minhash_inter(hs, counts, pa, pb))
            assert int(inter.max()) > 100


def test_wrappers_check_their_inputs(monkeypatch):
    codes = torch.zeros((2, 5), dtype=torch.int8)
    with pytest.raises(ValueError):
        mc.minhash_hash(codes, torch.zeros(2, dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        mc.minhash_hash(codes, torch.zeros(2, dtype=torch.int32), 17)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        mc.DeviceMinHash(16)
