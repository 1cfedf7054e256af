"""The case builders of the port's timing tools, on the CPU: the chip
smoke's timing block and round timing task that smoothxg_tpu_torch/tools/
time_chase.py times (the same draws as chip_smoke.py's phases 3 and 6),
the smoke's round task groups, tools/ring_reach.py's count of how far
back a task's predecessor rows lie, and tools/round_cuts.py's cuts, which
must still apply to csrc/poa_round.cu."""
import collections
import functools

import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops.poa_round import pack_tasks
from smoothxg_tpu_torch.tools import round_cuts, time_chase
from smoothxg_tpu_torch.tools.ring_reach import count


@functools.lru_cache(maxsize=None)
def timing_task():
    return time_chase.round_timing_task()


def test_timing_block_is_the_smokes_main_path_block():
    blk = time_chase.timing_block()
    assert len(blk) == 16
    assert all(990 <= len(s) <= 1010 for s in blk)
    assert blk[0].dtype == np.uint8


def test_round_timing_task_follows_the_smokes_groups():
    """The draw after the phase-6 groups: V 1,220 x L 1,004, local; the
    groups hold in-degrees 2-15, a query past 2^15 and a chain past 2^16
    nodes."""
    rng = np.random.default_rng(time_chase.SEED + 1)
    groups = time_chase.round_groups(rng)
    g, q, p = time_chase.round_timing_task(rng)
    assert (g.n_nodes(), len(q), p.local) == (1220, 1004, True)
    g2, q2, _ = timing_task()
    assert g2.n_nodes() == 1220 and np.array_equal(q, q2)
    assert len(groups) == len(time_chase.ROUND_PLAN) + 4
    assert sum(len(t) for _, t in groups) >= 200
    degrees = {len(ps) for _, tasks in groups for g, _, _ in tasks
               for ps in g.preds}
    assert set(range(1, 16)) <= degrees
    (_, [(_, long_q, _)]), (local, [(chain, _, _)]) = groups[-2:]
    assert len(long_q) > 1 << 15 and chain.n_nodes() > 1 << 16
    assert not local


def test_copies_repeat_a_batch():
    one = [torch.arange(6, dtype=torch.int32).reshape(1, 2, 3),
           torch.ones(1, dtype=torch.int32)]
    got = time_chase.copies(one, 4, torch.device("cpu"))
    assert got[0].shape == (4, 2, 3) and got[1].tolist() == [1] * 4
    assert all(torch.equal(x, one[0][0]) for x in got[0])


def test_ring_reach_counts_real_predecessor_slots():
    """Slots past a row's in-degree repeat slot 0 and are not read; a row
    without predecessors reads row 0."""
    preds = np.array([[[0, 0, 0], [1, 1, 1], [2, 1, 2], [3, 1, 2]]],
                     np.int32)
    hist = collections.Counter()
    count(hist, np.array([4]), preds)
    # rows 1-4: row 1 reads row 0; row 2 row 1; row 3 rows 2, 1; row 4
    # rows 3, 1, 2
    assert hist == collections.Counter({1: 4, 2: 2, 3: 1})
    g, q, p = timing_task()
    ins, _ = pack_tasks([(g, q, p)])
    hist = collections.Counter()
    count(hist, ins[0].numpy(), ins[5].numpy())
    assert sum(hist.values()) == sum(max(len(ps), 1) for ps in g.preds)
    assert hist[1] > sum(hist.values()) // 2


def test_round_cuts_apply_to_the_kernel():
    """Every timing cut finds its text exactly once in the kernel source,
    and each variant differs from the source as built."""
    with open(f"{round_cuts._PKG}/csrc/poa_round.cu") as f:
        src = f.read()
    outs = [round_cuts.patched(src, cuts) for _, cuts in round_cuts.VARIANTS]
    assert outs[0] == src
    assert len(set(outs)) == len(outs)
    with pytest.raises(ValueError, match="traceback"):
        round_cuts.patched(outs[1], ("traceback",))
