"""The source of the batch kernel of `--engine jax`, csrc/poa_batch.cu,
compiled with g++ against the CUDA emulation of smoothxg_tpu_torch/testing/
cuda_emu.h and run on the CPU (threads and barriers stand in for the
card's), against its unchanged plain PyTorch version ops/poa_batch.py:
poa_batch_reference: exact equality of out, outpos and bv (every output is
an integer, so no tolerance) on seeded tasks, local and global, in every
route the launch geometry takes:
  * one-tile rows with the ring of recent rows in shared memory, at one
    warp and at several (a warp's first lane rebuilds its left column from
    the left warp's published prefix), with predecessors inside the ring
    and past it (8 and more rows back, read from device memory);
  * slot buckets P 4, 8 and 16, with slots that repeat an earlier row;
  * rows of more than 2,048 columns, walked in tiles;
  * row tables in device memory: pushed there by a small emulated shared
    memory, and by more tasks than SMs whose tables would not leave room
    for two blocks an SM;
  * V = 0 and L = 0 tasks beside normal ones;
  * tracebacks whose runs of diagonal moves break on a branch row, an E
    step and an F step.
A launch a few bytes under 48 KB of dynamic shared memory, which must
opt in for the kernel's static buffers.
Also the timing switches of tools/batch_cuts.py: each still names its
`#if` in the source, and the two that keep the outputs (the tiled route
for every row, the tables in device memory) still equal the plain
version.  Each launch runs under a timeout, since a barrier race shows as
a hang."""
import collections
import re

import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_batch import (pack_tasks, poa_batch_reference,
                                              task_words)
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_fan_in_task, make_round_task
from smoothxg_tpu_torch.tools import batch_cuts
from smoothxg_tpu_torch.tools.ring_reach import count_batch

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    return cuda_emu.build("poa_batch", str(tmp_path_factory.mktemp("batch")))


def run(exe, ins, local, **device):
    """The emulated kernel's outputs held to the plain version on the same
    packed inputs; returns (outputs, geometry)."""
    got, geo = cuda_emu.run_batch_geometry(exe, *ins, local, timeout=300,
                                           **device)
    want = poa_batch_reference(*ins, local)
    for name, g, w in zip(("out", "outpos", "bv"), got, want):
        assert torch.equal(g, w.to(torch.int32)), name
    # the wrapper allocates the scratch the kernel addresses
    assert geo["task_words"] == task_words(ins[0].shape[0], ins[2].shape[1])
    return got, geo


def far_task(rng, local, length=150, gap=20):
    """A task whose graph holds a `gap`-base insertion, so the row past it
    reads a predecessor gap + 1 rows back."""
    p = poa_host.POAParams(local=local)
    s0 = rng.choice(ACGT, length)
    cut = length // 2
    s1 = np.concatenate([s0[:cut], rng.choice(ACGT, gap), s0[cut:]])
    g = POAGraph()
    g.add_sequence(s0, 1)
    g.add_alignment(poa_host.align(g, s1, p), s1, 1)
    return g, s0[5:length - 5].copy(), p


def ring_bytes(Lp: int, threads: int) -> int:
    """Shared bytes of the ring route without the tables (csrc/poa_batch.cu:
    ring_bytes): 8 rows of H, E1 and E2, and each warp's 4 published
    prefixes of 5 words and 16 last columns."""
    return 3 * 8 * ((Lp + 4) & ~3) * 4 + threads // 32 * (4 * 5 + 16) * 4


def reach(ins) -> collections.Counter:
    hist = collections.Counter()
    count_batch(hist, ins[4].numpy(), ins[1].numpy())
    return hist


@pytest.mark.parametrize("local", [True, False])
def test_ring_rows_inside_and_past_the_ring(exe, local):
    """One-tile rows of one warp and of four; predecessors 1-7 rows back
    from the ring, 8 and more from device memory."""
    rng = np.random.default_rng(61 + int(local))
    p = poa_host.POAParams(local=local)
    small = [make_round_task(rng, int(rng.integers(20, 28)), 3, 0.08, p)
             for _ in range(2)]
    ins, _ = pack_tasks(small)
    _, geo = run(exe, ins, local)
    assert (geo["threads"], geo["ring"], geo["tables"]) == (32, 1, 1)
    wide = [make_round_task(rng, int(rng.integers(380, 460)), 3, 0.06, p),
            far_task(rng, local)]
    ins, _ = pack_tasks(wide)
    _, geo = run(exe, ins, local)
    assert geo["threads"] == 4 * 32 and geo["ring"] == 1
    hist = reach(ins)
    assert max(hist) >= 8 and any(2 <= d <= 7 for d in hist)


def repeat_slots(ins):
    """The same tasks with every row's slots shifted up by one, so that
    slot 1 repeats slot 0 and the k-th distinct row moves to slot k + 1:
    the rows read stay, the slot codes change (each row's last slot must
    repeat its first)."""
    base, pred, *rest = ins
    assert torch.equal(pred[:, :, -1], pred[:, :, 0])
    new = pred.clone()
    new[:, :, 1:] = pred[:, :, :-1]
    return (base, new, *rest)


@pytest.mark.parametrize("P", [4, 8, 16])
@pytest.mark.parametrize("local", [True, False])
def test_slot_buckets_with_repeated_slots(exe, local, P):
    """Fan-in tasks of in-degree up to P - 1 beside a mutated family, at
    each slot bucket; then with every row's second slot repeating its
    first, so the first-occurrence slots are 0, 2, 3, ...: the same
    moves and scores."""
    rng = np.random.default_rng(100 * P + int(local))
    p = poa_host.POAParams(local=local)
    width = {4: 3, 8: 7, 16: 15}[P]
    tasks = [make_fan_in_task(rng, width, 30, p),
             make_round_task(rng, 60, 4, 0.1, p)]
    ins, _ = pack_tasks(tasks, P)
    assert ins[1].shape[2] == P
    want, _ = run(exe, ins, local)
    rep = repeat_slots(ins)
    got, _ = run(exe, rep, local)
    assert not torch.equal(rep[1], ins[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("local", [True, False])
def test_tiled_rows(exe, local):
    """Rows of more than 2,048 columns: 512 threads walk each row in
    tiles, the F prefix carried across them, predecessors from device
    memory."""
    rng = np.random.default_rng(71 + int(local))
    p = poa_host.POAParams(local=local)
    g, q, _ = make_round_task(rng, 40, 3, 0.05, p)
    long_q = np.concatenate([rng.choice(ACGT, 1100), q,
                             rng.choice(ACGT, 1000)])
    ins, _ = pack_tasks([(g, long_q, p), (g, q, p)])
    _, geo = run(exe, ins, local)
    assert (geo["threads"], geo["ring"]) == (512, 0)


@pytest.mark.parametrize("local", [True, False])
def test_tables_in_device_memory(exe, local):
    """The row tables in device memory: pushed there by an emulated card
    with room for the ring only, on rows of two warps with a predecessor
    past the ring."""
    rng = np.random.default_rng(81 + int(local))
    p = poa_host.POAParams(local=local)
    tasks = [make_round_task(rng, int(rng.integers(180, 240)), 3, 0.06, p),
             make_fan_in_task(rng, 7, 40, p), far_task(rng, local, 200, 12)]
    ins, _ = pack_tasks(tasks)
    Vp, Lp = ins[0].shape[0], ins[2].shape[1]
    ring = ring_bytes(Lp, 64)
    smem = ring + 512 + 2048                  # room for the ring only
    _, geo = run(exe, ins, local, smem_block=smem, smem_sm=smem + 1024)
    assert (geo["ring"], geo["tables"], geo["smem"]) == (1, 0, ring)
    assert 2 * Vp * ins[1].shape[2] > 2048 and max(reach(ins)) >= 8


def test_tables_leave_room_for_two_blocks_an_sm(exe):
    """More tasks than SMs: where the ring and the tables would not leave
    room for two blocks an SM, the tables go to device memory (an emulated
    card of 2 SMs, shared memory for two rings and a little more)."""
    rng = np.random.default_rng(91)
    p = poa_host.POAParams(local=True)
    tasks = [make_round_task(rng, 60, 3, 0.08, p) for _ in range(3)]
    ins, _ = pack_tasks(tasks, 16)
    Lp = ins[2].shape[1]
    ring = ring_bytes(Lp, 32)
    sm = 2 * (ring + 512 + 1024) + 512
    _, geo = run(exe, ins, True, sms=2, smem_sm=sm)
    assert (geo["tables"], geo["per_sm"]) == (0, 2)
    _, geo = run(exe, ins, True, sms=3, smem_sm=sm)
    assert (geo["tables"], geo["per_sm"]) == (1, 1)


@pytest.mark.parametrize("local", [True, False])
def test_empty_tasks_beside_normal_ones(exe, local):
    """A task with no rows and a task with an empty query, beside two
    normal ones, in one launch."""
    rng = np.random.default_rng(95 + int(local))
    p = poa_host.POAParams(local=local)
    tasks = [make_round_task(rng, 50, 3, 0.08, p) for _ in range(2)]
    g, q, _ = tasks[0]
    ins, _ = pack_tasks(tasks + [(POAGraph(), q, p), (g, q[:0], p)])
    assert int(ins[4][2]) == 0 and int(ins[3][3]) == 0
    got, _ = run(exe, ins, local)
    assert int(got[1][2]) == (0 if local else len(q))
    assert int(got[1][0]) > 0 and int(got[1][1]) > 0


def moves(got, b):
    k = int(got[1][b])
    return [tuple(x) for x in got[0][b, :k].tolist()]


@pytest.mark.parametrize("local", [True, False])
def test_traceback_runs_break_on_branch_e_and_f_steps(exe, local):
    """Queries with a deleted stretch (E steps), inserted stretches (F
    steps; one of 40 bases that ends at column 127, whose H the second
    warp's first lane rebuilds from the long-gap channel F2 for its
    diagonal move) and a graph branch (a match whose next row is not the
    row above): the read-ahead runs of diagonal moves stop at each, and
    the moves equal the plain version's."""
    rng = np.random.default_rng(97 + int(local))
    p = poa_host.POAParams(local=local)
    s0 = rng.choice(ACGT, 240)
    s1 = s0.copy()
    s1[60:70] = rng.choice(ACGT, 10)           # a bubble: a branch row
    g = POAGraph()
    g.add_sequence(s0, 1)
    g.add_alignment(poa_host.align(g, s1, p), s1, 1)
    q = np.concatenate([s1[:87], rng.choice(ACGT, 40), s1[87:110],
                        s1[122:170], rng.choice(ACGT, 9), s1[170:]])
    # 40 inserted up to column 127, 12 deleted, 9 inserted
    ins, orders = pack_tasks([(g, q, p)])
    got, _ = run(exe, ins, local)
    mv = moves(got, 0)
    assert any(r >= 1 and c == -1 for r, c in mv)            # E steps
    assert any(r == -1 and c >= 0 for r, c in mv)            # F steps
    rows = [r for r, c in mv if r >= 1 and c >= 0]
    assert any(a - b > 1 for a, b in zip(rows, rows[1:]))    # a branch


def test_launch_in_the_last_bytes_under_48_kb(exe):
    """48,960 bytes of dynamic shared memory: under 48 KB, but not with
    the kernel's own __shared__ buffers, so the launch must opt in to
    them (csrc/smem.cuh).  Without the opt-in the card refused this launch
    (an invalid argument, found by tools/sanitize_drive.py); the emulation
    counts 512 static bytes for every kernel."""
    rng = np.random.default_rng(20261022)
    p = poa_host.POAParams(local=True)
    tasks = [make_round_task(rng, 150 + 100 * i, 3, 0.03, p)
             for i in range(3)] + [make_fan_in_task(rng, 12, 100, p)]
    ins, _ = pack_tasks(tasks)
    _, geo = run(exe, ins, True)
    assert 48 * 1024 - 512 < geo["smem"] <= 48 * 1024


def test_batch_cuts_name_their_switches():
    """Every cut of tools/batch_cuts.py guards code of the kernel source
    under its bit, and the variants are distinct."""
    with open(f"{batch_cuts._PKG}/csrc/poa_batch.cu") as f:
        src = f.read()
    for name, bit in batch_cuts.CUTS.items():
        assert re.search(rf"BATCH_CUTS & {bit}\b", src), name
    masks = [batch_cuts.mask(cuts) for _, cuts in batch_cuts.VARIANTS]
    assert masks[0] == 0 and len(set(masks)) == len(masks)
    assert set(batch_cuts.KEEP) <= set(batch_cuts.CUTS)


@pytest.mark.parametrize("cuts", [("ring off",), ("device lists",),
                                  ("ring off", "device lists")])
def test_cuts_that_keep_the_outputs(tmp_path, cuts):
    """The tiled route for every row and the tables in device memory are
    route choices: built under their switches the kernel still equals the
    plain version, and reports the route it took."""
    exe = cuda_emu.build("poa_batch", str(tmp_path),
                         defines=[f"BATCH_CUTS={batch_cuts.mask(cuts)}"])
    rng = np.random.default_rng(99)
    for local in (True, False):
        p = poa_host.POAParams(local=local)
        tasks = [make_round_task(rng, 150, 3, 0.08, p),
                 far_task(rng, local, 120, 10)]
        ins, _ = pack_tasks(tasks)
        _, geo = run(exe, ins, local)
        assert geo["ring"] == int("ring off" not in cuts)
        assert geo["tables"] == int("device lists" not in cuts)
