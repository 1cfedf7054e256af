"""poa_win's cluster route (csrc/poa_win.cu: a stored DP row past one tile
runs on a cluster of thread blocks, one a tile, the F carry handed on
through distributed shared memory and a cluster barrier ending every row)
compiled against the CUDA emulation (testing/cuda_emu.h: a cluster's
blocks run at once, each with its own shared memory) and held to the plain
version, exactly: every output is an integer.

The emulation runs a thread as an OS thread, so most cases build the
source with a smaller thread block (POA_NT = 32: tiles of 256 columns),
which keeps a row's tile count, the cluster sizes 2-5 and the
tile-boundary rows at a few hundred bases a sequence, and align a long
sequence against a short graph (few rows, each of many tiles); one case
runs the card's own 256-thread build on a row of 2,049 columns.  Covered:
full width and banded, local and global, rows of exactly TILE, TILE + 1
and 2 TILE + 1 columns, a band wider than a tile (its window starts in one
CTA's span and ends in the next), the row metadata in shared memory and in
the device tables, the route each launch chose, equality with the one-CTA
kernel, and a cluster the card cannot hold, which fails the launch."""
import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_win import (TILE, WinCaps, pack_blocks,
                                            poa_win_reference, row_stride)
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_block

NTS = (32, 256)             # thread blocks of the builds: tiles of NT x 8


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    d = tmp_path_factory.mktemp("cluster")
    with ThreadPoolExecutor(2) as pool:
        futs = {nt: pool.submit(
            cuda_emu.build, "poa_win", str(d / f"nt{nt}"),
            [f"POA_NT={nt}"] if nt != 256 else []) for nt in NTS}
        return {nt: f.result() for nt, f in futs.items()}


def run(exe, seqs, p, caps, **device):
    """The emulated launch's outputs and geometry and the plain version's
    outputs on one block."""
    ins = pack_blocks([(seqs, p)], caps.LW)
    LS = row_stride(ins[1], caps.LW)
    got, geo = cuda_emu.run_geometry(exe, *ins, caps, caps.scratch_words(LS),
                                     LS=LS, timeout=300, **device)
    return got, geo, poa_win_reference(*ins, caps), LS


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def cut(rng, lens, div=0.04) -> list:
    """Sequences of the given lengths, prefixes of one seeded block's
    mutated copies: the first two, short, make a graph with branches (few
    rows), against which the later, longer ones align in rows of many
    columns."""
    sq = make_block(rng, max(lens) + 40, len(lens), div)
    return [s[:n] for s, n in zip(sq, lens)]


@pytest.mark.parametrize("local", [True, False])
def test_tile_boundary_rows(exes, local):
    """Tiles of 256 columns, a launch of 3-CTA clusters (LS 544): rows of
    exactly 256 columns (one CTA has columns), 257 (the second CTA one
    column) and 513 (the third CTA one column).  The card's 256-thread
    build keeps these rows in one 2,048-column tile and takes the one-CTA
    kernel, with the same outputs."""
    rng = np.random.default_rng(61 + local)
    seqs = cut(rng, [100, 100, 255, 256, 512])
    p = POAParams(local=local)
    caps = WinCaps(1024, 640, 640, local, False)
    got, geo, want, LS = run(exes[32], seqs, p, caps)
    assert_equal(got, want)
    assert int(want[0][0, 1]) == 0
    assert LS == 544 and caps.cluster(LS, 256) == 3
    assert (geo["cluster"], geo["grid"], geo["tables"]) == (3, 3, "device")
    if local:
        one, geo1, _, _ = run(exes[256], seqs, p, caps)
        assert_equal(one, got)
        assert geo1["cluster"] == 1 and caps.cluster(LS) == 1


@pytest.mark.parametrize("local", [True, False])
def test_band_wider_than_a_tile(exes, local):
    """Banded rows in a window of 520 columns (3 tiles of 256): with wb
    150 a row's band is ~330 columns, so it starts in one CTA's span and
    ends in the next, and a predecessor's window sits at its own band
    floor, read across spans."""
    rng = np.random.default_rng(71 + local)
    seqs = cut(rng, [380, 400, 390][:3 if local else 2])
    p = POAParams(local=local, wb=150, wf_milli=30)
    caps = WinCaps(1024, 640, 520, local, True)
    got, geo, want, LS = run(exes[32], seqs, p, caps)
    assert_equal(got, want)
    assert int(want[0][0, 1]) == 0
    assert geo["cluster"] == caps.cluster(LS, 256) == 3
    assert geo["meta"] == "shared"


# (cluster size, banded): the row metadata in the device tables for C 3
# and 5 (an emulated card whose shared memory holds the sequence and the
# control words only), in each CTA's shared memory for C 2 and 4; local
# on even sizes
CLUSTERS = [(c, bd) for c in (2, 3, 4, 5) for bd in (False, True)]


@pytest.mark.parametrize("C,banded", CLUSTERS)
def test_cluster_sizes(exes, C, banded):
    """Tiles of 256 columns: a row of C tiles (full width, or banded in a
    window that holds the band of a long sequence against a short graph),
    local and global, against the plain version."""
    rng = np.random.default_rng(80 + 2 * C + banded)
    top = (C - 1) * 256 + 90
    seqs = cut(rng, [100, 100, top])
    local = C % 2 == 0
    W = (C - 1) * 256 + 200 if banded else top + 1
    LW = -(-max(W, top + 1) // 128) * 128
    if banded:
        p = POAParams(local=local, wb=40, wf_milli=30)
        caps = WinCaps(4 * LW, LW, W, local, True)
    else:
        p = POAParams(local=local)
        caps = WinCaps(4 * LW, LW, LW, local, False)
    device = {}
    if C % 2:
        LS = row_stride(pack_blocks([(seqs, p)], LW)[1], LW)
        small = 2048 + LS + 1024 + 512
        device = {"smem_block": small, "smem_sm": small + 1024}
    got, geo, want, LS = run(exes[32], seqs, p, caps, **device)
    assert_equal(got, want)
    assert int(want[0][0, 1]) == 0
    assert geo["cluster"] == caps.cluster(LS, 256) == C
    assert geo["meta"] == ("device" if C % 2 else "shared")


def test_full_size_tiles(exes):
    """The card's 256-thread build: a row of 2,049 columns (2,048-column
    tiles: the second CTA holds one column)."""
    rng = np.random.default_rng(97)
    seqs = cut(rng, [100, 2048])
    p = POAParams(local=False)
    caps = WinCaps(4096, 2176, 2176, False, False)
    got, geo, want, LS = run(exes[256], seqs, p, caps)
    assert_equal(got, want)
    assert int(want[0][0, 1]) == 0
    assert LS == 2080 and TILE == 2048
    assert geo["cluster"] == caps.cluster(LS) == 2


def test_overflow_is_canonical_on_every_route(exes):
    """A block past its node capacity overflows on the cluster route as
    on the plain version: meta [0, 1, nseq, 0], -1 everywhere."""
    rng = np.random.default_rng(101)
    seqs = cut(rng, [100, 100, 300])
    p = POAParams(local=True)
    caps = WinCaps(160, 384, 384, True, False)
    got, geo, want, _ = run(exes[32], seqs, p, caps)
    assert_equal(got, want)
    assert want[0][0].tolist() == [0, 1, 3, 0]
    assert geo["cluster"] == 2


def test_a_cluster_the_card_cannot_hold_fails_the_launch(exes):
    """On an emulated card of one SM a cluster of two CTAs has nowhere to
    run: the launch is refused with an error (the wrapper raises on it),
    and no other route runs in its place."""
    rng = np.random.default_rng(103)
    seqs = cut(rng, [100, 300])
    caps = WinCaps(1024, 384, 384, True, False)
    with pytest.raises(cuda_emu.LaunchError, match="rc 9"):
        run(exes[32], seqs, POAParams(local=True), caps, sms=1)


def test_sanitized_cluster_route(tmp_path):
    """The cluster route built under AddressSanitizer and UBSan (a CTA's
    emulated shared memory is exactly its launch's bytes: the control
    words, the row metadata and the sequence, so an access past them is a
    report): 3-CTA rows at full width with the metadata in the device
    tables, and banded with it in shared memory."""
    exe = cuda_emu.build("poa_win", str(tmp_path), ["POA_NT=32"],
                         sanitize=True)
    rng = np.random.default_rng(107)
    seqs = cut(rng, [80, 80, 600])
    for local, banded in ((False, False), (True, True)):
        p = POAParams(local=local, wb=40 if banded else -1, wf_milli=30)
        caps = WinCaps(2048, 640, 640, local, banded)
        device = {}
        if not banded:
            small = 2048 + 640 + 1024 + 512
            device = {"smem_block": small, "smem_sm": small + 1024}
        got, geo, want, _ = run(exe, seqs, p, caps, **device)
        assert_equal(got, want)
        assert int(want[0][0, 1]) == 0
        assert geo["cluster"] == 3
        assert geo["meta"] == ("shared" if banded else "device")
