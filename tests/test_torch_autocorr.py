"""The port's batched autocorrelation route (smoothxg_tpu_torch/ops/
autocorr.py) against the JAX package's (smoothxg_tpu/ops/autocorr.py):
`repeat_batch(device="cpu")` equal to the JAX `repeat_batch` and to the
port's `repeat` exactly, on the five sequences and two parameter sets of
the JAX package's own test and at the CLI's defaults (lags 1,000-20,000
every 50) on seeded 2-20 kb rows; the plain version of the counts equal to
the jitted `_counts_fn` on rows with N and lower-case bytes, lengths across
the 256 bucket, every lag % 4 and lags past a row's hi; and
csrc/autocorr.cu compiled against the CUDA emulation, equal to the plain
version on every route (A/C/G/T, with N, a few escapes, bytes) and edge
(lengths about a stretch, every lag % 32, lags past every row, a negative
lag, garbage padding), its units staged in shared memory or read from
device memory, on emulated grids of 1, 2, 16 and 132 SMs; the byte route
taken past 3 escape words in 10 and not below; its plan covering
every window once in units of at most a stretch x 32 lags; and the
emulation's warp reductions, gridDim, __threadfence and cudaMemsetAsync
against their definitions."""
import os
import subprocess

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
    """The units staged in shared memory, and (a small emulated shared
    memory) every unit read from device memory; Lpad 601 padded to 604 by
    word_rows; three lag groups; rows of lower case and N-free junk on the
    byte route."""
    rows, lens, lags = (torch.from_numpy(x)
                        for x in _count_inputs(Lpad=601, garbage=True))
    want = ac.autocorr_counts_reference(rows, lens, lags)
    got, geo, plan = cuda_emu.run_autocorr(autocorr_exe, ac.word_rows(rows),
                                           lens, lags, smem_block=smem_block,
                                           timeout=120)
    budget = min(6144, smem_block // 4)
    # the unit list's capacity: 12 rows x the lag groups x one byte
    # stretch; a pack block a row (one chunk of 8,192 positions); two
    # staging buffers
    cap = 12 * -(-len(lags) // geo["lags_per_unit"])
    assert geo == {"grid": cap, "threads": 256, "smem": 4 * budget,
                   "blocks_per_sm": 8, "unit_cap": cap, "pack_blocks": 12,
                   "lags_per_unit": 32, "buffer_words": budget // 2}
    assert plan["routes"] == {"acgt": 4, "acgtn": 3, "escape": 0,
                              "bytes": 5}
    assert plan["device_units"] == (plan["units"] if smem_block == 256
                                    else 0)
    assert torch.equal(got, want)


def test_kernel_emulated_on_long_rows(autocorr_exe):
    """Tandem rows of 6 and 20 kb and a row of ACGTN at a grid of 1,000-
    10,000 every 250 (a third of the lags 3 past it): the plan covers every
    (row, lag) window once, in units of at most kLG lags x a stretch,
    most of them full."""
    rows = [s.encode() for s in _cli_rows()[:2]] + [b"ACGTN" * 700]
    Lpad = max(len(s) for s in rows) + 4 - max(len(s) for s in rows) % 4
    buf = np.zeros((len(rows), Lpad), np.uint8)
    for b, s in enumerate(rows):
        buf[b, :len(s)] = np.frombuffer(s, np.uint8)
    lens = torch.tensor([len(s) for s in rows], dtype=torch.int32)
    lags = torch.arange(1000, 10001, 250, dtype=torch.int32)
    lags[::3] += 3
    want = ac.autocorr_counts_reference(torch.from_numpy(buf), lens, lags)
    got, _, plan = cuda_emu.run_autocorr(autocorr_exe, torch.from_numpy(buf),
                                         lens, lags, timeout=120)
    assert torch.equal(got, want)
    assert plan["routes"] == {"acgt": 2, "acgtn": 1, "escape": 0,
                              "bytes": 0}
    pos = ac.unit_positions(plan, lens.numpy(), lags.numpy())
    win = np.clip(lens.numpy()[:, None].astype(np.int64)
                  - lags.numpy()[None, :], 0, None)
    assert pos.sum() == win.sum() and pos.min() > 0
    full = plan["lags_per_unit"] * plan["stretch"]["acgt"]
    assert pos.max() <= full and (pos == full).sum() >= 1
    # the stated spread: every unit holds a stretch times its lag group
    # but where the group's windows end, and a group of lags that spans
    # less than a stretch ends in at most two of its stretches
    u = plan["list"].numpy()
    for key in {(b, w >> 16) for b, _, _, w in u}:
        mine = (u[:, 0] == key[0]) & (u[:, 3] >> 16 == key[1])
        assert (pos[mine] < full).sum() <= 2


def _edge_rows():
    """Rows for every route and edge of the kernel (Lpad 9,004, garbage
    padding): lengths 0, 1, a stretch of A/C/G/T less one, exactly one and
    one more (7,167-7,169), a tandem row; the 256 byte values in random
    order, all lower case; all N and N runs a lag apart (1,000 and 64:
    route 1); a run of every byte value, each repeated or changed 1,000
    later, and escapes at a row's first and last position (route 2: at
    most 3 in 10 words hold an escape); junk of a byte stretch less one,
    exactly one and one more (route 3)."""
    rng = np.random.default_rng(41)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    Lpad = 9004
    rows = []

    def dna(n):
        return acgt[rng.integers(0, 4, n)]
    rows += [dna(0), dna(1), dna(7167), dna(7168), dna(7169),
             np.resize(dna(33), 4000)]
    rows.append(rng.permutation(np.resize(np.arange(256, dtype=np.uint8),
                                          3000)))
    rows.append(np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, 2000)])
    rows.append(np.full(2500, ord("N"), np.uint8))
    r = dna(5000)
    for a, ln in ((500, 60), (1500, 60), (564, 36), (3000, 700)):
        r[a:a + ln] = ord("N")
    rows.append(r)
    r = dna(9000)
    for i in range(256):
        r[100 + i] = i
        r[1100 + i] = i if i % 2 else (i + 1) % 256
    rows.append(r)
    r = dna(3000)
    r[[0, 1000, 2999]] = ord("x")
    r[1999] = ord("y")
    rows.append(r)
    rows += [rng.integers(0, 256, n).astype(np.uint8)
             for n in (1151, 1152, 1153)]
    buf = rng.integers(0, 256, (len(rows), Lpad)).astype(np.uint8)
    for b, s in enumerate(rows):
        buf[b, :len(s)] = s
    lens = np.array([len(s) for s in rows], np.int32)
    # every residue mod 32 (so mod 16 and 4), stretch and row edges, lags
    # past every row and a negative one
    lags = np.array(list(range(34)) + [63, 64, 65, 1000, 1151, 1152, 1153,
                                       5000, 7167, 7168, 7169, 9000, 9500,
                                       -3], np.int32)
    return buf, lens, lags


EDGE_ROUTES = {"acgt": 6, "acgtn": 2, "escape": 2, "bytes": 5}


@pytest.fixture(scope="module")
def edge_counts():
    buf, lens, lags = (torch.from_numpy(x) for x in _edge_rows())
    return buf, lens, lags, ac.autocorr_counts_reference(buf, lens, lags)


@pytest.mark.parametrize("sms,smem_block", [(16, cuda_emu.SMEM_BLOCK),
                                            (1, cuda_emu.SMEM_BLOCK),
                                            (2, 2048)])
def test_kernel_emulated_routes_and_edges(autocorr_exe, edge_counts, sms,
                                          smem_block):
    """Every route and edge of `_edge_rows` equal to the plain version,
    with the persistent grid of 16 SMs, of one SM (every block walks many
    units) and of two SMs whose shared memory holds no stretch (every unit
    from device memory): the atomics' order changes, the counts do not.
    (Fewer SMs than the card's keep the emulation's threads few: the grid
    is 8 blocks an SM, most of them idle on a batch this small.)"""
    buf, lens, lags, want = edge_counts
    assert int(want[6, 0]) == 3000 and int(want[9, lags.tolist().index(1000)]) > 0
    got, geo, plan = cuda_emu.run_autocorr(autocorr_exe, buf, lens, lags,
                                           sms=sms, smem_block=smem_block,
                                           timeout=120)
    assert plan["routes"] == EDGE_ROUTES
    assert geo["grid"] == min(8 * sms, geo["unit_cap"])
    assert plan["device_units"] == (plan["units"] if smem_block < 4096
                                    else 0)
    assert torch.equal(got, want)


def test_kernel_emulated_wide_lag_spread(autocorr_exe):
    """A lag group whose shifted windows no shared budget holds (lags 1 and
    24,001 of a 25 kb byte-route row): its units read device memory, the
    rest stage; both exact."""
    rng = np.random.default_rng(43)
    buf = rng.integers(0, 256, (2, 25000)).astype(np.uint8)
    buf[1] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 25000)]
    lens = torch.tensor([25000, 24990], dtype=torch.int32)
    lags = torch.tensor([1, 24001, 5, 7] + list(range(100, 1300, 100)) +
                        [2, 3], dtype=torch.int32)
    want = ac.autocorr_counts_reference(torch.from_numpy(buf), lens, lags)
    got, _, plan = cuda_emu.run_autocorr(autocorr_exe, torch.from_numpy(buf),
                                         lens, lags, sms=4, timeout=120)
    assert plan["routes"] == {"acgt": 1, "acgtn": 0, "escape": 0,
                              "bytes": 1}
    assert 0 < plan["device_units"] < plan["units"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("words,clustered,route", [
    (30, False, "escape"), (31, False, "bytes"), (93, True, "escape")])
def test_kernel_emulated_byte_route_threshold(autocorr_exe, words,
                                              clustered, route):
    """A 3,200-base row (100 words of 32 positions) takes the byte route
    once more than 3 of 10 words hold an escape: 30 words with one escape
    each stay on route 2, 31 go to route 3, and 93 escapes in three runs
    (6 words) stay on route 2.  Exact either way."""
    rng = np.random.default_rng(47 + words)
    r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3200)].copy()
    if clustered:
        for a in (100, 1100, 2100):
            r[a:a + 31] = np.frombuffer(b"acgt", np.uint8)[
                rng.integers(0, 4, 31)]
    else:
        r[32 * rng.choice(100, words, replace=False) + 7] = ord("x")
    buf = torch.from_numpy(r[None])
    lens = torch.tensor([3200], dtype=torch.int32)
    lags = torch.tensor([1, 31, 32, 1000, 1001, 2000], dtype=torch.int32)
    want = ac.autocorr_counts_reference(buf, lens, lags)
    got, _, plan = cuda_emu.run_autocorr(autocorr_exe, buf, lens, lags,
                                         sms=2, timeout=120)
    assert plan["routes"][route] == 1 and sum(plan["routes"].values()) == 1
    assert torch.equal(got, want)


def test_emulated_warp_reduce_memset_and_grid(tmp_path):
    """cuda_emu.h's __reduce_min_sync / __reduce_max_sync (signed and
    unsigned), gridDim, __threadfence and cudaMemsetAsync against their
    definitions."""
    src = tmp_path / "t.cpp"
    src.write_text(r"""
#include "cuda_emu.h"
#include <cstdio>
__global__ void k(int* out) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int v = (lane * 7 + 3 * w) % 13 - 5;
    const int mn = __reduce_min_sync(0xffffffffu, v);
    const int mx = __reduce_max_sync(0xffffffffu, v);
    const unsigned um = __reduce_max_sync(0xffffffffu, 3u * lane + w);
    const unsigned un = __reduce_min_sync(0xffffffffu, 0xfffffff0u - lane);
    if (lane == 0) {
        int* o = out + (blockIdx.x * 2 + w) * 5;
        o[0] = mn; o[1] = mx; o[2] = (int)um; o[3] = (int)un;
        __threadfence();
        o[4] = gridDim.x;
    }
}
int main() {
    std::vector<int> out(3 * 2 * 5 + 2, 7);
    emu::launch(3, 64, 0, nullptr, k, out.data());
    cudaMemsetAsync(out.data() + 30, 0, 4);
    for (int v : out) std::printf("%d ", v);
    return 0;
}
""")
    exe = tmp_path / "t"
    subprocess.run(["g++", "-std=c++20", "-pthread", "-w", "-I",
                    os.path.dirname(cuda_emu.__file__), "-o", str(exe),
                    str(src)], check=True, timeout=120)
    got = [int(x) for x in subprocess.run([str(exe)], capture_output=True,
                                          text=True, timeout=60,
                                          check=True).stdout.split()]
    want = []
    for _ in range(3):
        for w in range(2):
            v = [(lane * 7 + 3 * w) % 13 - 5 for lane in range(32)]
            want += [min(v), max(v), 3 * 31 + w, 0xfffffff0 - 31 - (1 << 32),
                     3]
    assert got == want + [0, 7]


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
