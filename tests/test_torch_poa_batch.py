"""The port's batched round module (smoothxg_tpu_torch/ops/poa_batch.py,
`--engine jax`) against the jitted XLA function it replaces
(smoothxg_tpu/ops/poa_jax.py:_compiled, on the CPU) and its engine
(JaxPOAEngine), and csrc/poa_batch.cu on the CUDA emulation against the
plain version.  Graphs are grown from seeded mutated sequences, once with
each package's own classes, and packed once (pack_tasks), so both functions
see the same arrays.  Tolerance: none, every output is an integer."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothxg_tpu.ops import poa_host as jax_host
from smoothxg_tpu.ops.poa_graph import POAGraph as JaxGraph
from smoothxg_tpu.ops.poa_jax import JaxPOAEngine, _compiled
from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_batch import (TorchBatchPOAEngine,
                                              decode_moves, pack_tasks,
                                              poa_batch, poa_batch_reference)
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.testing import cuda_emu

ALPHA = np.frombuffer(b"ACGT", np.uint8)
PSET = (1, 4, 6, 2, 26, 1)
# fan-in widths that put each batch in one slot bucket of the XLA engine
WIDTH = {4: 3, 8: 7, 16: 16}


def mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r >= rate / 2:
            out.append(rng.choice(ALPHA) if r < rate else ch)
        if rng.random() < rate / 4:
            out.append(rng.choice(ALPHA))
    return np.array(out, np.uint8)


def grow(seqs, local, pset=PSET):
    """The same sequences grown into a POA graph of each package."""
    pj = jax_host.POAParams(*pset, local=local)
    pp = poa_host.POAParams(*pset, local=local)
    gj, gp = JaxGraph(), POAGraph()
    gj.add_sequence(seqs[0], 1)
    gp.add_sequence(seqs[0], 1)
    for s in seqs[1:]:
        gj.add_alignment(jax_host.align(gj, s, pj), s, 1)
        gp.add_alignment(poa_host.align(gp, s, pp), s, 1)
    assert gj.preds == gp.preds and gj.base == gp.base
    return gj, gp, pj, pp


def fan_in(local, width):
    """A node with `width` predecessors: one middle base per sequence."""
    mids = b"ACGTNRYKMSWBDHVX"[:width]
    seqs = [np.frombuffer(b"GATTACA" + bytes([x]) + b"CCAGT", np.uint8)
            for x in mids]
    return grow(seqs, local)


@functools.lru_cache(maxsize=None)
def tasks(local, P, seed=0):
    """Four seeded (jax task, port task) pairs, V and L up to ~64: three
    mutated families and a fan-in that sets the slot bucket P."""
    rng = np.random.default_rng(1000 * P + 10 * seed + local)
    out = []
    for k in range(3):
        base = rng.choice(ALPHA, int(rng.integers(16, 34)))
        rate = (0.03, 0.08, 0.15)[k]
        fam = [base] + [mutate(rng, base, rate)
                        for _ in range(int(rng.integers(1, 3)))]
        gj, gp, pj, pp = grow(fam, local)
        q = mutate(rng, base, rate)[:63]
        out.append(((gj, q, pj), (gp, q, pp)))
    gj, gp, pj, pp = fan_in(local, WIDTH[P])
    q = np.frombuffer(b"GTTTACAKCCAGTA", np.uint8)
    out.append(((gj, q, pj), (gp, q, pp)))
    return out


def xla(ins, local):
    """The XLA function, jitted on the CPU, on the port's packed arrays."""
    base, pred, seq, slen, nvalid, sink, par = (x.numpy() for x in ins)
    V, B = base.shape
    fn = _compiled(B, V, seq.shape[1] + 1, pred.shape[2], local)
    out = fn(*(jnp.asarray(x) for x in
               (base, pred, seq, slen, nvalid, sink, par)))
    return tuple(torch.from_numpy(np.asarray(x).astype(np.int32))
                 for x in out)


def same(got, want):
    for name, g, w in zip(("out", "outpos", "bv"), got, want):
        assert torch.equal(g.to(torch.int32), w.to(torch.int32)), name


@pytest.mark.parametrize("P", [4, 8, 16])
@pytest.mark.parametrize("local", [True, False])
def test_reference_equals_the_xla_function(local, P):
    """Bit for bit on out, outpos and bv: local buckets (the XLA function
    in int16) and global ones (int32), each slot bucket."""
    ins, _ = pack_tasks([t for _, t in tasks(local, P)])
    assert ins[1].shape[2] == P
    assert ins[0].shape[0] <= 64 and ins[2].shape[1] <= 64
    want = xla(ins, local)
    same(poa_batch_reference(*ins, local), want)
    assert int(want[1].min()) > 0


@pytest.mark.parametrize("local", [True, False])
def test_padding_does_not_change_the_outputs(local):
    """Packed into a larger (V, L), every task keeps its moves and score:
    rows past nvalid and columns past slen never reach an output."""
    ins, _ = pack_tasks([t for _, t in tasks(local, 8)])
    base, pred, seq, slen, nvalid, sink, par = ins
    V, B = base.shape
    big = (torch.cat([base, torch.zeros((9, B), dtype=torch.int32)]),
           torch.cat([pred, torch.zeros((9, B, 8), dtype=torch.int32)]),
           torch.cat([seq, torch.full((B, 11), -1, dtype=torch.int32)], 1),
           slen, nvalid,
           torch.cat([sink, torch.zeros((B, 9), dtype=torch.bool)], 1), par)
    got = poa_batch_reference(*big, local)
    want = poa_batch_reference(*ins, local)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for b in range(B):
        k = int(want[1][b])
        assert torch.equal(got[0][b, :k], want[0][b, :k])
    same(xla(big, local), got)


@pytest.fixture(scope="module")
def emu_exe(tmp_path_factory):
    return cuda_emu.build("poa_batch", str(tmp_path_factory.mktemp("batch")))


@pytest.mark.parametrize("P", [4, 16])
@pytest.mark.parametrize("local", [True, False])
def test_kernel_on_the_emulation_equals_the_plain_version(emu_exe, local,
                                                          P):
    ins, _ = pack_tasks([t for _, t in tasks(local, P, seed=1)])
    same(cuda_emu.run_batch(emu_exe, *ins, local, timeout=240),
         poa_batch_reference(*ins, local))


def test_kernel_on_the_emulation_takes_tiles_and_empty_tasks(emu_exe):
    """A row of more than one tile (the F carry across tiles) and a task
    with no rows, beside a normal one."""
    rng = np.random.default_rng(77)
    base = rng.choice(ALPHA, 60)
    gj, gp, pj, pp = grow([base, mutate(rng, base, 0.05)], True)
    long_q = np.concatenate([rng.choice(ALPHA, 1500), base,
                             rng.choice(ALPHA, 700)])
    for local in (True, False):
        pp = poa_host.POAParams(*PSET, local=local)
        ins, _ = pack_tasks([(gp, long_q, pp), (gp, base, pp)])
        assert ins[2].shape[1] + 1 > 1024
        ins[4][1] = 0                       # no rows (and so no sink)
        ins[5][1] = False
        want = poa_batch_reference(*ins, local)
        same(cuda_emu.run_batch(emu_exe, *ins, local, timeout=240), want)


def test_batches_past_65535_columns_are_refused(emu_exe):
    """The kernel keeps an F origin column in 16 bits: the wrapper and
    the plain version alike refuse a batch of more than 65,535 columns,
    and so does the kernel's launcher (the engine sends tasks past L
    30,000 to the host).  65,535 columns still run."""
    def ins(Lp):
        return (torch.zeros((1, 1), dtype=torch.int32),
                torch.zeros((1, 1, 4), dtype=torch.int32),
                torch.full((1, Lp), -1, dtype=torch.int32),
                torch.tensor([Lp], dtype=torch.int32),
                torch.ones(1, dtype=torch.int32),
                torch.tensor([[False, True]]),
                torch.tensor([PSET], dtype=torch.int32))
    for fn in (poa_batch, poa_batch_reference):
        with pytest.raises(ValueError, match="at most 65535 columns"):
            fn(*ins(65536), True)
    with pytest.raises(RuntimeError, match="rc 1"):
        cuda_emu.run_batch(emu_exe, *ins(65536), True, timeout=60)
    out, outpos, bv = poa_batch_reference(*ins(65535), True)
    assert out.shape == (1, 1 + 65535 + 5, 2)
    assert int(outpos[0]) == 0 and int(bv[0]) == 0


@pytest.mark.parametrize("local", [True, False])
def test_engine_equals_the_jax_engine(local):
    """Task for task, with JaxPOAEngine's shape buckets on one side and
    the port's real-size packing on the other."""
    pairs = [p for P in (4, 8, 16) for p in tasks(local, P)]
    want = JaxPOAEngine().align_batch([j for j, _ in pairs])
    eng = TorchBatchPOAEngine(device="cpu")
    got = eng.align_batch([t for _, t in pairs])
    assert got == want
    st = eng.stats()
    assert st["device_tasks"] == len(pairs) and st["fallbacks"] == 0
    assert st["calls"] == 1 and st["kernel_launches"] == 0


def test_engine_host_fallbacks_follow_the_jax_engine():
    """In-degree above max_pred goes to the host, as in JaxPOAEngine."""
    (gj, qj, pj), (gp, qp, pp) = tasks(True, 16)[3]
    want = JaxPOAEngine(max_pred=8).align_batch([(gj, qj, pj)])
    eng = TorchBatchPOAEngine(max_pred=8, device="cpu")
    assert eng.align_batch([(gp, qp, pp)]) == want
    assert eng.stats()["fallback_reasons"]["max_pred"] == 1


def test_banded_task_goes_to_the_oracle():
    """The XLA function has no band (ROADMAP C7): a banded task runs on
    poa_host.align, counted."""
    rng = np.random.default_rng(5)
    base = rng.choice(ALPHA, 120)
    fam = [base, mutate(rng, base, 0.1), mutate(rng, base, 0.1)]
    _, gp, _, _ = grow(fam, False)
    p = poa_host.POAParams(*PSET, local=False, wb=2, wf_milli=0)
    q = mutate(rng, base, 0.1)
    eng = TorchBatchPOAEngine(device="cpu")
    assert eng.align_batch([(gp, q, p)]) == [poa_host.align(gp, q, p)]
    assert eng.stats()["fallback_reasons"]["band"] == 1
    assert eng.stats()["device_tasks"] == 0


def test_uniform_shape_truncation_goes_to_the_oracle():
    """With uniform_shape, JaxPOAEngine keeps the first 16 predecessors
    of a node; the port sends such a task to the oracle instead."""
    seqs = [np.frombuffer(b"GATTACA" + bytes([x]) + b"CCAGT", np.uint8)
            for x in range(17)]
    _, gp, _, pp = grow(seqs, True)
    assert max(len(ps) for ps in gp.preds) == 17
    q = np.frombuffer(b"GATTACA\x05CCAGT", np.uint8)
    eng = TorchBatchPOAEngine(uniform_shape=(64, 64), device="cpu")
    assert eng.align_batch([(gp, q, pp)]) == [poa_host.align(gp, q, pp)]
    assert eng.stats()["fallback_reasons"]["truncated"] == 1


def test_int16_wrap_of_the_xla_function():
    """ROADMAP C9: a local bucket up to 8,199 columns runs in int16, where
    G = hq + e * j wraps once e * j passes 32,767 (e = 5 past column
    6,553).  The best alignment below needs a one-base insertion in the
    sequence past that column: the XLA function misses it, the port
    (int32) finds the oracle's score."""
    rng = np.random.default_rng(9)
    node = rng.choice(ALPHA, 60)
    pset = (1, 4, 6, 5, 26, 1)
    _, gp, _, pp = grow([node], True, pset)
    q = np.concatenate([rng.choice(ALPHA, 6700), node[:30],
                        np.frombuffer(b"A", np.uint8), node[30:],
                        rng.choice(ALPHA, 200)])
    ins, orders = pack_tasks([(gp, q, pp)])
    H = poa_host.fill(gp, q, pp)[0]
    best = int(H.max())
    assert best == 60 - 6
    want = xla(ins, True)
    assert int(want[2][0]) < best                 # the XLA function
    got = poa_batch_reference(*ins, True)
    assert int(got[2][0]) == best                 # the port
    aln = decode_moves(got[0][0], int(got[1][0]), orders[0])
    assert aln == poa_host.align(gp, q, pp)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    ins, _ = pack_tasks([t for _, t in tasks(True, 4)])
    before = poa_batch.launches
    same(poa_batch(*ins, True), poa_batch_reference(*ins, True))
    assert poa_batch.launches == before


def test_engine_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        TorchBatchPOAEngine()
