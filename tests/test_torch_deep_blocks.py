"""Deep blocks (pggb passes its haplotype count as -r, so a block holds
about as many sequences as the pangenome has haplotypes) through the port's
block engine on the CPU: the sequence cap derived for the H100 and the
routing at it, the launch size counting the sequence and path planes, and
seeded blocks of 64 and 96 sequences through the plain versions of the
three whole-block kernels (poa_win, shape= poa_code, kernel="stacked"
poa_stacked) against the native engine and, on a small shape, the JAX
package's FusedPallasEngine in interpret mode.  Graphs must be equal
(integers, no tolerance); a kernel's overflow flag must be raised exactly
when the native graph has a node of more predecessors than the kernel's
slots."""
import dataclasses
import functools

import numpy as np
import pytest

from smoothxg_tpu.ops.poa_host import POAParams as JaxParams
from smoothxg_tpu.ops.poa_pallas_fused import FusedPallasEngine
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine
from smoothxg_tpu_torch.ops.poa_win import PCAP, stride_for
from smoothxg_tpu_torch.testing.synth import make_population_block

# (engine options, predecessor slots of its kernel); one narrow tier, so
# that the plain versions' planes stay small
KERNELS = {"win": ({"tiers": ((4352, 64, 64),)}, PCAP),
           "code": ({"shape": (4352, 64)}, 8),
           "stacked": ({"kernel": "stacked", "tiers": ((4352, 64, 64),)}, 4)}
DEPTHS = (64, 96)
P = POAParams(local=True)


@functools.lru_cache(maxsize=None)
def deep_block(n: int) -> list:
    """n sequences of ~16 bp from 4 founders, a private SNV each (the
    smallest shape make_block draws, so the plain versions stay quick)."""
    return make_population_block(np.random.default_rng(n), 16, n, 0.005,
                                 founders=4)


@functools.lru_cache(maxsize=None)
def native_graph(n: int):
    sq = deep_block(n)
    return NativePOAEngine().poa_block_batch([(sq, [1] * n, P)])[0]


@functools.lru_cache(maxsize=None)
def engine_run(kernel: str, n: int):
    sq = deep_block(n)
    eng = TorchPOAEngine(device="cpu", **KERNELS[kernel][0])
    graph = eng.poa_block_batch([(sq, [1] * n, P)])[0]
    return graph, eng.stats()


def in_degree(graph) -> int:
    preds: dict = {}
    for pth in graph.seq_paths:
        for u, v in zip(pth, pth[1:]):
            preds.setdefault(v, set()).add(u)
    return max(map(len, preds.values()))


def same_graph(g, h) -> None:
    assert g.base == h.base
    assert g.seq_paths == h.seq_paths
    assert g._topo == h._topo
    assert g.group == h.group


def one_block_bytes(eng, depth: int) -> int:
    """Bytes of one block of `depth` sequences at the tier and variant
    whose block needs the most: DP scratch and the two planes."""
    return max(
        4 * eng._kernel(VW, LW, W, True, banded)[2](stride_for(LW, LW))
        + eng.PLANE_BYTES * depth * LW
        for VW, LW, W in eng.tiers
        for banded in ((True,) if W < LW else (False, True)))


@pytest.mark.parametrize("options,cap", [
    ({}, 487241), ({"kernel": "stacked"}, 500360),
    ({"shape": (8704, 4096)}, 1230411), ({"max_batch": 3}, 487241)])
def test_default_cap_is_the_depth_at_which_one_block_fills_the_budget(
        options, cap):
    """The default sequence cap: the deepest block whose DP scratch and
    sequence and path planes fit SCRATCH_BUDGET at every tier, so that no
    launch passes it; it does not depend on the blocks a launch."""
    eng = TorchPOAEngine(device="cpu", **options)
    assert eng.RW == cap
    assert one_block_bytes(eng, cap) <= eng.SCRATCH_BUDGET
    assert one_block_bytes(eng, cap + 1) > eng.SCRATCH_BUDGET
    assert TorchPOAEngine(device="cpu", max_seqs=48, **options).RW == 48


def test_route_takes_a_deep_block_to_a_tier_and_past_the_cap_to_native(
        monkeypatch):
    """A 96-sequence block of ~1 kb reads routes to a tier under the
    default (48 sent it to the native engine); under a budget that holds
    one block of 40 sequences at the widest tier, a block of cap + 1
    sequences goes to the native engine, counted as a fallback, while cap
    sequences of it route to a tier."""
    deep = make_population_block(np.random.default_rng(7), 1000, 96, 0.01)
    assert TorchPOAEngine(device="cpu")._route(deep, P) is not None
    assert TorchPOAEngine(device="cpu", max_seqs=48)._route(deep, P) is None
    monkeypatch.setattr(TorchPOAEngine, "SCRATCH_BUDGET", one_block_bytes(
        TorchPOAEngine(device="cpu"), 40))
    eng = TorchPOAEngine(device="cpu")
    assert eng.RW == 40
    seq = np.frombuffer(b"ACGTTGCA", np.uint8)
    past = [seq] * (eng.RW + 1)
    assert eng._route(past[:-1], P) == 0
    assert eng._route(past, P) is None
    got = eng.poa_block_batch([(past, [1] * len(past), P)])[0]
    want = NativePOAEngine().poa_block_batch([(past, [1] * len(past), P)])[0]
    same_graph(got, want)
    st = eng.stats()
    assert st["fallbacks"] == 1 and st["device_blocks"] == 0
    assert st["kernel_launches"] == 0


@pytest.mark.parametrize("ti,maxlen", [(0, 1100), (4, 10000)])
@pytest.mark.parametrize("depth", [16, 96, 2000])
def test_tier_batch_counts_the_sequence_and_path_planes(ti, maxlen, depth):
    """A launch holds what SCRATCH_BUDGET holds of its blocks' DP scratch
    and their int8 sequence and int32 path planes (RW x LW each), at most
    max_batch: deeper blocks, fewer a launch."""
    eng = TorchPOAEngine(device="cpu")
    VW, LW, W = eng.tiers[ti]
    banded = W < LW
    words = eng._kernel(VW, LW, W, True, banded)[2](stride_for(maxlen, LW))
    want = min(eng.max_batch,
               eng.SCRATCH_BUDGET // (4 * words + 5 * depth * LW))
    got = eng._tier_batch(ti, banded, maxlen, depth)
    assert got == want
    assert got <= eng._tier_batch(ti, banded, maxlen, 1)
    if depth == 2000:
        # the planes cost each tier blocks a launch at such a depth
        assert got < eng._tier_batch(ti, banded, maxlen, 16)


@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_deep_block_equals_the_native_engine(kernel, n):
    """A seeded block of 64 or 96 sequences through the kernel's plain
    version gives the native engine's graph; it is redone natively exactly
    when its graph has a node past the kernel's predecessor slots."""
    graph, st = engine_run(kernel, n)
    want = native_graph(n)
    same_graph(graph, want)
    over = in_degree(want) > KERNELS[kernel][1]
    assert (st["redo"], st["device_blocks"]) == ((1, 0) if over else (0, 1))
    assert st["fallbacks"] == 0 and st["kernel_launches"] == 0


def test_win_slots_hold_what_the_tpu_slots_redo():
    """poa_win holds 8 predecessor slots: the deep fixture has a node of
    in-degree past the TPU's 4 and still stays on the kernel
    (test_torch_kernel_emu holds the source at 8 and overflows it at 9)."""
    assert PCAP == 8
    assert max(in_degree(native_graph(n)) for n in DEPTHS) > 4
    assert all(engine_run("win", n)[1]["device_blocks"] == 1
               for n in DEPTHS)


@pytest.mark.parametrize("n", DEPTHS)
def test_deep_block_equals_fused_pallas_engine_interpret(n):
    """The JAX package computes the same graph at that depth:
    FusedPallasEngine(max_seqs=96, interpret=True) on a small shape, as
    test_torch_engine_tiers holds the engine at 16."""
    sq = deep_block(n)
    pal = FusedPallasEngine(shape=(1024, 128), max_seqs=96, max_batch=1,
                            interpret=True)
    ref = pal.poa_block_batch(
        [(sq, [1] * n, JaxParams(**dataclasses.asdict(P)))])[0]
    assert pal.stats()["device_blocks"] == 1
    graph = engine_run("win", n)[0]
    assert graph.base == ref.base
    assert graph.seq_paths == ref.seq_paths
    assert graph._topo == ref._topo
    assert graph.group == ref.group
