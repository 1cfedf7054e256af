"""The port's split-stage banded identity (smoothxg_tpu_torch/ops/
ident_cuda.py) against the JAX package's (smoothxg_tpu/ops/ident_jax.py):
identities bit-identical to JAX DeviceBandedIdentity on the CPU and to the
port's numpy mirror, and scores and counts equal to the mirror's, on
seeded pairs: related at several divergences, with indels, pairs that
leave the band, lb = 0 and empty pairs, and pairs bailed by max_score; a
band of 32 and one of 64; and csrc/ident.cu compiled against the CUDA
emulation, equal to its plain version at bands 32, 64, 128 and 256 (the
warp kernel, one warp a pair), 96, 160 and 224 (its other column counts)
and 288 (the block kernel, one thread a column).  (The pair past 46,340
bp, ROADMAP C3: test_torch_ident_long.py.)"""
import numpy as np
import pytest
import torch

from smoothxg_tpu.ops import ident_jax
from smoothxg_tpu_torch.ops import ident_cuda as ic
from smoothxg_tpu_torch.testing import cuda_emu


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(rng, s, p):
    out = []
    for ch in s:
        r = rng.random()
        if r < p / 3:
            continue                                     # deletion
        if r < 2 * p / 3:
            out.append(_seq(rng, int(rng.integers(1, 4))))   # insertion
        elif r < p:
            ch = "ACGT"[(("ACGT".index(ch)) + 1) % 4]
        out.append(ch)
    return "".join(out)


def make_pairs(seed: int, n: int = 24, maxlen: int = 500):
    rng = np.random.default_rng(seed)
    pairs = []
    for t in range(n):
        a = _seq(rng, int(rng.integers(1, maxlen)))
        if t % 6 == 5:
            b = _seq(rng, int(rng.integers(0, maxlen)))      # unrelated
        elif t % 6 == 4:                   # a long gap: leaves the band
            cut = int(rng.integers(0, len(a)))
            b = a[:cut] + _seq(rng, 200) + a[cut:]
        else:
            b = _mutate(rng, a, float(rng.choice([0.0, 0.02, 0.1, 0.3])))
        pairs.append((a, b) if t % 2 else (b, a))
    pairs += [("ACGT" * 40, ""), ("", ""), ("A", "T"), ("ACGTN", "acgtn")]
    return pairs


def _counts(pairs, band=128):
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    return ic.ident_counts(*(packed[n] for n in ("a", "aoff", "la", "b",
                                                 "boff", "lb")), band)


@pytest.mark.parametrize("seed", [0, 1])
def test_identities_bit_identical_to_jax_and_mirror(seed):
    pairs = make_pairs(seed)
    ms = [len(a) if t % 3 else None for t, (a, _) in enumerate(pairs)]
    mine = ic.DeviceBandedIdentity(device="cpu").identities(pairs, ms)
    jax_dev = ident_jax.DeviceBandedIdentity().identities(pairs, ms)
    assert mine == jax_dev
    mirror = [ic.host_banded_identity(a, b, max_score=m)
              for (a, b), m in zip(pairs, ms)]
    assert mine == mirror
    assert 0.0 in mine and max(mine) == 1.0


@pytest.mark.parametrize("band", [128, 64, 32])
def test_counts_equal_the_mirror(band):
    pairs = make_pairs(2, 16, 400)
    got = _counts(pairs, band).numpy()
    want = np.array([ic.host_banded_identity(a, b, band=band,
                                             return_counts=True)
                     for a, b in pairs])
    assert np.array_equal(got, want)


def test_bail_on_max_score():
    a = "ACGT" * 50
    b = a[:100] + "T" * 30 + a[100:]
    sc = ic.host_banded_identity(a, b, return_counts=True)[0]
    dev = ic.DeviceBandedIdentity(device="cpu")
    assert dev.identities([(a, b)], max_score=sc + 1)[0] > 0.8
    assert dev.identities([(a, b)], max_score=sc) == [0.0]


@pytest.fixture(scope="module")
def ident_exe(tmp_path_factory):
    return cuda_emu.build("ident", str(tmp_path_factory.mktemp("ident")))


def test_kernel_emulated_matches_plain_version(ident_exe):
    """The warp kernel at 32-256 columns and the block kernel past 256,
    chosen by the band alone; 12 pairs, so the last block of four warps
    holds one pair."""
    pairs = make_pairs(3, 8, 260)
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n] for n in ("a", "aoff", "la", "b", "boff", "lb")]
    for band in (128, 32, 64, 256, 288):
        got = cuda_emu.run_ident(ident_exe, *ins, band=band, timeout=120)
        assert torch.equal(got, ic.ident_counts(*ins, band))


@pytest.mark.parametrize("band", [96, 160, 224])
def test_kernel_emulated_other_column_counts(ident_exe, band):
    pairs = make_pairs(4, 5, 400)
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n] for n in ("a", "aoff", "la", "b", "boff", "lb")]
    got = cuda_emu.run_ident(ident_exe, *ins, band=band, timeout=120)
    assert torch.equal(got, ic.ident_counts(*ins, band))
    want = np.array([ic.host_banded_identity(a, b, band=band,
                                             return_counts=True)
                     for a, b in pairs])
    assert np.array_equal(got.numpy(), want)


def tie_pairs(seed: int = 0, n: int = 60):
    """Pairs of 20-300 bp at 30% divergence: the in-row gap's prefix
    minimum ties, now and then, between columns that carry other
    counts."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a = _seq(rng, int(rng.integers(20, 300)))
        pairs.append((a, _mutate(rng, a, 0.3)))
    return pairs


@pytest.mark.parametrize("band", [32, 64, 128])
def test_kernel_emulated_takes_the_earliest_column_on_ties(ident_exe, band):
    """The warp kernel's scans keep the earliest column on a tie, as the
    plain version's packed keys (and the mirror's left-preferring prefix)
    do."""
    pairs = tie_pairs()
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n] for n in ("a", "aoff", "la", "b", "boff", "lb")]
    got = cuda_emu.run_ident(ident_exe, *ins, band=band, timeout=120)
    assert torch.equal(got, ic.ident_counts(*ins, band))


def test_wrapper_checks_its_inputs(monkeypatch):
    packed = ic.pack_pairs([ic._prep_pair("ACGT", "ACG")])
    ins = [packed[n] for n in ("a", "aoff", "la", "b", "boff", "lb")]
    with pytest.raises(ValueError):
        ic.ident_counts(*ins, band=7)
    with pytest.raises(ValueError):
        ic.ident_counts(ins[0], ins[1].int(), *ins[2:])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        ic.DeviceBandedIdentity()
