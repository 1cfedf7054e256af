"""The port's batched autocorrelation route (smoothxg_tpu_torch/ops/
autocorr.py) against the JAX package's (smoothxg_tpu/ops/autocorr.py):
`repeat_batch(device="cpu")` equal to the JAX `repeat_batch` and to the
port's `repeat` exactly, on the five sequences and two parameter sets of
the JAX package's own test and at the CLI's defaults (lags 1,000-20,000
every 50) on seeded 2-20 kb rows; the plain version of the counts equal to
the jitted `_counts_fn` on rows with N and lower-case bytes, lengths across
the 256 bucket, every lag % 4 and lags past a row's hi; and
csrc/autocorr.cu compiled against the CUDA emulation, equal to the plain
version with its rows in shared memory and in device memory."""
import numpy as np
import pytest
import torch

from smoothxg_tpu.ops import autocorr as jac
from smoothxg_tpu_torch.ops import autocorr as ac
from smoothxg_tpu_torch.testing import cuda_emu


def _rand(rng, n, alphabet="ACGT"):
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def _five():
    """The JAX package's test sequences (tests/test_pipeline.py)."""
    rng = np.random.default_rng(13)
    unit = _rand(rng, 50)
    return [unit * 80, _rand(rng, 4000), _rand(rng, 90),
            (unit + "TTACG") * 40, _rand(rng, 2500)]


def _cli_rows():
    """Seeded 2-20 kb rows: tandem repeats of 1,000-2,000 bp periods (with
    point mutations) and random rows, one with a run of N."""
    rng = np.random.default_rng(29)
    out = []
    for period, n in ((1000, 6000), (1500, 20000), (2050, 12000)):
        s = list((_rand(rng, period) * (n // period + 1))[:n])
        for pos in rng.integers(0, n, n // 100):
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        out.append("".join(s))
    out += [_rand(rng, 2000), _rand(rng, 9000),
            _rand(rng, 3000) + "N" * 2000 + _rand(rng, 3000)]
    return out


def _same(got, want):
    assert [(r.length, r.z_score) for r in got] == \
        [(r.length, r.z_score) for r in want]


@pytest.mark.parametrize("params", [(20, 130, 5, 2.0), (100, 2000, 50, 6.0)])
def test_repeat_batch_equals_jax_and_repeat(params):
    min_lag, max_lag, stride, z = params
    seqs = _five()
    got = ac.repeat_batch(seqs, min_lag, max_lag, min_z=z, stride=stride,
                          device="cpu")
    _same(got, jac.repeat_batch(seqs, min_lag, max_lag, min_z=z,
                                stride=stride))
    _same(got, [ac.repeat(s, min_lag, max_lag, min_z=z, stride=stride)
                for s in seqs])


def test_repeat_batch_at_cli_defaults():
    seqs = _cli_rows()
    got = ac.repeat_batch(seqs, 1000, 20000, device="cpu")
    _same(got, jac.repeat_batch(seqs, 1000, 20000))
    _same(got, [ac.repeat(s, 1000, 20000) for s in seqs])
    # the longer tandem rows report a multiple of their period; the 6 kb
    # one (3 multiples among 41 lags) and the random rows stay under z 5
    assert got[1].length % 1500 == 0 and got[1].length > 0
    assert got[2].length % 2050 == 0 and got[2].length > 0
    assert [r.length for r in got[:1] + got[3:]] == [0.0] * 4


def _count_inputs(Lpad=None, garbage=False):
    """Rows with N and lower-case bytes, lengths 0-257 and 600, and lags of
    every residue mod 4, past half a row and past whole rows."""
    rng = np.random.default_rng(5)
    lens = np.array([0, 1, 3, 4, 5, 9, 100, 255, 256, 257, 600, 130],
                    np.int32)
    Lpad = Lpad or int(lens.max())
    alpha = np.frombuffer(b"ACGTNacgtn", np.uint8)
    rows = (np.random.default_rng(6).integers(0, 256, (len(lens), Lpad))
            .astype(np.uint8) if garbage
            else np.zeros((len(lens), Lpad), np.uint8))
    for b, n in enumerate(lens):
        rows[b, :n] = rng.choice(alpha[:5] if b % 2 else alpha, n)
    rows[6, 20:60] = ord("N")
    rows[11, :] = np.tile(np.frombuffer(b"ACGTA", np.uint8), Lpad)[:Lpad]
    lags = np.array(list(range(1, 13)) + [63, 64, 65, 66, 127, 128, 129,
                                          130, 200, 255, 256, 257, 299,
                                          300, 301, 302, 450, 599, 600,
                                          1000, 5000],
                    np.int32)
    return rows, lens, lags


def test_counts_reference_equals_xla_function():
    rows, lens, lags = _count_inputs(Lpad=1024)      # the JAX bucket
    want = np.asarray(jac._counts_fn(1024, len(lags))(rows, lens, lags))
    got = ac.autocorr_counts(*(torch.from_numpy(x) for x in (rows, lens,
                                                              lags)))
    assert got.dtype == torch.int32 and got.shape == (len(lens), len(lags))
    assert np.array_equal(got.numpy(), want)
    # without the bucket, and with garbage past every length: the same
    rows2, _, _ = _count_inputs(garbage=True)
    got2 = ac.autocorr_counts_reference(torch.from_numpy(rows2),
                                        torch.from_numpy(lens),
                                        torch.from_numpy(lags))
    assert np.array_equal(got2.numpy(), want)


def test_counts_reference_chunks_over_lags(monkeypatch):
    rows, lens, lags = (torch.from_numpy(x) for x in _count_inputs())
    want = ac.autocorr_counts_reference(rows, lens, lags)
    monkeypatch.setattr(ac, "_CHUNK_ELEMS", rows.numel() * 3)
    assert torch.equal(ac.autocorr_counts_reference(rows, lens, lags), want)


@pytest.fixture(scope="module")
def autocorr_exe(tmp_path_factory):
    return cuda_emu.build("autocorr", str(tmp_path_factory.mktemp("ac")))


@pytest.mark.parametrize("smem_block", [cuda_emu.SMEM_BLOCK, 256])
def test_kernel_emulated_matches_plain_version(autocorr_exe, smem_block):
    """The row in shared memory, and (a small emulated shared memory) read
    from device memory; Lpad 601 padded to 604 by word_rows; two chunks of
    lags."""
    rows, lens, lags = (torch.from_numpy(x)
                        for x in _count_inputs(Lpad=601, garbage=True))
    want = ac.autocorr_counts_reference(rows, lens, lags)
    got, geo = cuda_emu.run_autocorr(autocorr_exe, ac.word_rows(rows), lens,
                                     lags, smem_block=smem_block,
                                     timeout=120)
    assert geo == {"shared": int(smem_block > 604), "blocks": 2 * len(lens),
                   "threads": 256,
                   "smem": 604 if smem_block > 604 else 0}
    assert torch.equal(got, want)


def test_kernel_emulated_on_long_rows(autocorr_exe):
    rows = [s.encode() for s in _cli_rows()[:2]] + [b"ACGTN" * 700]
    Lpad = max(len(s) for s in rows) + 4 - max(len(s) for s in rows) % 4
    buf = np.zeros((len(rows), Lpad), np.uint8)
    for b, s in enumerate(rows):
        buf[b, :len(s)] = np.frombuffer(s, np.uint8)
    lens = torch.tensor([len(s) for s in rows], dtype=torch.int32)
    lags = torch.arange(1000, 10001, 250, dtype=torch.int32)
    lags[::3] += 3
    want = ac.autocorr_counts_reference(torch.from_numpy(buf), lens, lags)
    got, _ = cuda_emu.run_autocorr(autocorr_exe, torch.from_numpy(buf), lens,
                                   lags, timeout=120)
    assert torch.equal(got, want)


def test_kernel_refuses_unpadded_rows(autocorr_exe):
    rows, lens, lags = (torch.from_numpy(x)
                        for x in _count_inputs(Lpad=601))
    with pytest.raises(RuntimeError, match="emulated launch failed"):
        cuda_emu.run_autocorr(autocorr_exe, rows, lens, lags, timeout=60)


def test_word_rows_pads_to_words():
    rows = torch.arange(2 * 7, dtype=torch.uint8).reshape(2, 7)
    w = ac.word_rows(rows)
    assert w.shape == (2, 8) and torch.equal(w[:, :7], rows)
    assert int(w[:, 7].abs().sum()) == 0
    ok = torch.zeros((3, 8), dtype=torch.uint8)
    assert ac.word_rows(ok) is ok


def test_wrapper_checks_its_inputs():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    lags = torch.ones(3, dtype=torch.int32)
    assert ac.autocorr_counts(rows, lens, lags).shape == (2, 3)
    with pytest.raises(ValueError):
        ac.autocorr_counts(rows.int(), lens, lags)
    with pytest.raises(ValueError):
        ac.autocorr_counts(rows, lens[:1], lags)
    with pytest.raises(ValueError):
        ac.autocorr_counts(rows, lens, lags.long())


def test_repeat_batch_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the route runs there")
    with pytest.raises(RuntimeError, match="CUDA required"):
        ac.repeat_batch(_five(), 100, 2000, device="cuda")


def test_repeat_batch_edge_cases():
    assert ac.repeat_batch([], 10, 100, device="cpu") == []
    got = ac.repeat_batch(["ACGT", "A" * 30], 10, 100, device="cpu")
    assert [(r.length, r.z_score) for r in got] == [(0.0, 0.0)] * 2
    _same(got, jac.repeat_batch(["ACGT", "A" * 30], 10, 100))
