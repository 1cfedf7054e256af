"""The source of the round kernel, csrc/poa_round.cu, compiled with g++
against the CUDA emulation of smoothxg_tpu_torch/testing/cuda_emu.h and run
on the CPU (threads and barriers stand in for the card's), against its
plain PyTorch version ops/poa_round.py:poa_round_reference: exact equality
of the move codes and meta (every output is an integer, so no tolerance)
on seeded tasks, local and global, in every route the launch geometry
takes:
  * one-tile rows with the ring of recent rows in shared memory, at one
    warp and at several (a warp's first lane rebuilds its left column from
    the left warp's published maxima), with predecessors inside the ring
    and past it (distance 8 and more, read from device memory);
  * in-degrees up to 15, a padded slot (V = 0) and an empty query;
  * rows of more than 2,048 columns, walked in tiles;
  * a query past 2^15 bases, read from device memory;
  * row tables in device memory: a graph past int16 rows, and a small
    emulated shared memory.
Each launch runs under a timeout, since a barrier race shows as a hang."""
import collections

import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.ops.poa_round import pack_tasks, poa_round_reference
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_fan_in_task, make_round_task
from smoothxg_tpu_torch.tools.ring_reach import count

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    return cuda_emu.build("poa_round", str(tmp_path_factory.mktemp("round")))


def run(exe, tasks, local, **device):
    """The emulated kernel's (codes, meta) and geometry, held to the plain
    version on the same packed inputs; returns (inputs, meta, geometry)."""
    ins, _ = pack_tasks(tasks)
    (codes, meta), geo = cuda_emu.run_round(exe, *ins, local, timeout=240,
                                            **device)
    want = poa_round_reference(*ins, local)
    assert torch.equal(codes, want[0])
    assert torch.equal(meta, want[1])
    assert not meta[:, 2].any()
    return ins, meta, geo


def far_task(rng, local):
    """A task whose graph holds a 20-base insertion, so a row past it reads
    a predecessor 21 rows back."""
    p = poa_host.POAParams(local=local)
    s0 = rng.choice(ACGT, 150)
    s1 = np.concatenate([s0[:70], rng.choice(ACGT, 20), s0[70:]])
    g = POAGraph()
    g.add_sequence(s0, 1)
    g.add_alignment(poa_host.align(g, s1, p), s1, 1)
    return g, s0[5:145].copy(), p


@pytest.mark.parametrize("local", [True, False])
def test_ring_rows_match_plain_version(exe, local):
    """One-tile rows of 1 and 4 warps; predecessors 1-7 rows back from the
    ring, 8 and more from device memory."""
    rng = np.random.default_rng(41 + int(local))
    p = poa_host.POAParams(local=local)
    small = [make_round_task(rng, int(rng.integers(20, 28)), 3, 0.08, p)
             for _ in range(2)]
    ins, _, geo = run(exe, small, local)
    assert (geo["threads"], geo["ring"], geo["tables"]) == (32, 1, 1)
    wide = [make_round_task(rng, int(rng.integers(380, 460)), 3, 0.06, p),
            far_task(rng, local)]
    ins, meta, geo = run(exe, wide, local)
    assert geo["threads"] == 4 * 32 and geo["ring"] == 1
    hist = collections.Counter()
    count(hist, ins[0].numpy(), ins[5].numpy())
    assert max(hist) >= 8 and any(2 <= d <= 7 for d in hist)


@pytest.mark.parametrize("local", [True, False])
def test_fan_in_and_empty_slots_match_plain_version(exe, local):
    """In-degrees up to 15 (more than the four rows a row's metadata
    prefetches), a padded slot and an empty query."""
    rng = np.random.default_rng(43 + int(local))
    p = poa_host.POAParams(local=local)
    fan = [make_fan_in_task(rng, w, 30, p) for w in (5, 9, 15)]
    g, q, _ = fan[0]
    ins, meta, geo = run(exe, fan + [(POAGraph(), q, p), (g, q[:0], p)],
                         local)
    assert ins[5].shape[2] == 15
    assert meta[3].tolist() == meta[4].tolist() == [0, -(1 << 30), 0, 0]


@pytest.mark.parametrize("local", [True, False])
def test_tiled_rows_match_plain_version(exe, local):
    """Rows of more than 2,048 columns: 512 threads walk each row in
    tiles, predecessors from device memory, the sequence in shared
    memory."""
    rng = np.random.default_rng(45 + int(local))
    p = poa_host.POAParams(local=local)
    g, q, _ = make_round_task(rng, 30, 2, 0.05, p)
    long_q = np.concatenate([rng.choice(ACGT, 2100), q])
    _, _, geo = run(exe, [(g, long_q, p), (g, q, p)], local)
    assert (geo["threads"], geo["ring"], geo["seq_smem"]) == (512, 0, 1)


def test_long_query_reads_device_memory(exe):
    """A local query past 2^15 bases ends in the graph's sequence: the
    kernel reads it from device memory, in 17 tiles a row."""
    rng = np.random.default_rng(47)
    p = poa_host.POAParams(local=True)
    g, q, _ = make_round_task(rng, 24, 2, 0.03, p)
    long_q = np.concatenate([rng.choice(ACGT, 1 << 15), q])
    _, meta, geo = run(exe, [(g, long_q, p)], True)
    assert (geo["ring"], geo["seq_smem"]) == (0, 0)
    assert meta[0, 1] > 0


@pytest.mark.parametrize("local", [True, False])
def test_tables_in_device_memory_match_plain_version(exe, local):
    """The row tables in device memory: pushed there by an emulated card
    with less shared memory, on rows of two warps."""
    rng = np.random.default_rng(49 + int(local))
    p = poa_host.POAParams(local=local)
    tasks = [make_round_task(rng, int(rng.integers(180, 240)), 3, 0.06, p),
             make_fan_in_task(rng, 7, 40, p)]
    ins, _ = pack_tasks(tasks)
    VW, LS = ins[3].shape[1], ins[6].shape[1]
    ring = 3 * 8 * ((LS + 4) & ~3) * 4
    smem = ring + 1024 + 2048                  # room for the ring only
    _, _, geo = run(exe, tasks, local, smem_block=smem,
                    smem_sm=smem + 1024)
    assert (geo["ring"], geo["tables"]) == (1, 0)
    assert ring < geo["smem"] < ring + 2048 < ring + 2 * VW * ins[5].shape[2]


def test_graph_past_int16_rows_matches_plain_version(exe):
    """A global query against a chain of 33,000 nodes: node rows past
    int16 keep the row tables in device memory."""
    rng = np.random.default_rng(51)
    p = poa_host.POAParams(local=False)
    g, q, _ = make_round_task(rng, 33_000, 2, 0.01, p)
    _, meta, geo = run(exe, [(g, q[20_000:20_040].copy(), p)], False)
    assert geo["tables"] == 0 and geo["ring"] == 1
    assert meta[0, 0] > 0
