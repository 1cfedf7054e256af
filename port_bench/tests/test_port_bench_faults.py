"""A run with the timed path broken underneath comes out not correct: once
for each fault a smoothing cell can have.  The runs skip the look for a
card and use the port's CPU engines on the tiny traffic; on the card the
step that returns its state unchanged is read again at the cells' own
size, where `python -m pytest -s` prints each seed's readings as a JSON
line."""
import copy
import json
import time

import pytest
import torch

from port_bench.cell import run_cell
from port_bench.tests.tiny import make_root


def _native():
    from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine
    return NativePOAEngine


class AlteredBase(_native()):
    """An answer altered where it is produced: one base of one block's
    POA graph changed."""

    def poa_block_batch(self, blocks):
        graphs = super().poa_block_batch(blocks)
        g = graphs[0]
        v = g.n_nodes() // 2
        g.base[v] = ord("A") if g.base[v] != ord("A") else ord("C")
        return graphs


class HalfLeftOut(_native()):
    """Half of the batch left out: the second half of the blocks come back
    with no POA."""

    def poa_block_batch(self, blocks):
        from smoothxg_tpu_torch.ops.poa_graph import POAGraph
        graphs = super().poa_block_batch(blocks)
        keep = (len(graphs) + 1) // 2
        return graphs[:keep] + [POAGraph() for _ in graphs[keep:]]


class StaleGraph:
    """A step that returns its state unchanged: every sequence of a block
    is aligned against the graph as the block's first sequence left it."""

    def __init__(self):
        self.first = {}

    def stale(self, g):
        """The block's graph as its first sequence left it (the graph is
        held, so that its id names no other block's)."""
        held = self.first.get(id(g))
        if held is None or held[0] is not g:
            held = self.first[id(g)] = (g, copy.deepcopy(g))
        return held[1]

    def align_batch(self, tasks):
        from smoothxg_tpu_torch.ops import poa_host
        return [poa_host.align(self.stale(g), s, p) for g, s, p in tasks]


def stale_on_card():
    """StaleGraph on the port's round engine on the card (the kernel of
    `--engine jax`, `csrc/poa_batch.cu`), fast enough for the cells' own
    size."""
    from smoothxg_tpu_torch.ops.poa_batch import TorchBatchPOAEngine

    class StaleOnCard(TorchBatchPOAEngine, StaleGraph):
        def __init__(self):
            TorchBatchPOAEngine.__init__(self, device="cuda")
            StaleGraph.__init__(self)

        def align_batch(self, tasks):
            return TorchBatchPOAEngine.align_batch(
                self, [(self.stale(g), s, p) for g, s, p in tasks])
    return StaleOnCard()


@pytest.mark.parametrize("engine", [AlteredBase, HalfLeftOut, StaleGraph])
def test_broken_path_is_not_correct(tmp_path, engine):
    root = make_root(str(tmp_path))
    if engine is StaleGraph:
        factory = lambda cfg, device: StaleGraph()      # noqa: E731
    else:
        factory = lambda cfg, device: engine(threads=1)  # noqa: E731
    r = run_cell("tiny.cell", 2**31 + 21, 0.1, False, time.perf_counter(),
                 device="cpu", engine_factory=factory, root=root)
    assert r["attempted"] >= 1
    assert r["correct"] is False
    assert r["failed"] >= 1


def test_altered_output_is_not_correct(tmp_path, monkeypatch):
    """An answer altered past the program's own validation: one base of
    the smoothed graph changed as it is written."""
    from smoothxg_tpu_torch.pipeline import run as prun
    from port_bench.tests.tiny import native_engine
    write = prun.write_gfa

    def altered(g, path):
        steps = g.path_steps[g.path_names.index("hap0")]
        nid = steps[len(steps) // 2] >> 1
        s = g.seqs[nid]
        g.seqs[nid] = ("C" if s[0] != "C" else "G") + s[1:]
        return write(g, path)
    monkeypatch.setattr(prun, "write_gfa", altered)
    root = make_root(str(tmp_path))
    r = run_cell("tiny.cell", 2**31 + 22, 0.1, False, time.perf_counter(),
                 device="cpu", engine_factory=native_engine, root=root)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["paths_bad"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483701, 3000000061, 4000000087])
def test_card_stale_step_at_the_cells_size(seed):
    """One whole job of `l4000-band0.hap90` with the stale step.  The
    full-width cell: the round engine sends a banded task to its host
    oracle, which at this size would take hours."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t = time.perf_counter()
    r = run_cell("l4000-band0.hap90", seed, 0.1, False, t,
                 engine_factory=lambda cfg, device: stale_on_card())
    print(json.dumps({"seed": seed, "s": time.perf_counter() - t,
                      "attempted": r["attempted"], "checks": r["checks"]}))
    assert r["correct"] is False
    assert r["checks"]["poa_gap_max"]["value"] > \
        r["checks"]["poa_gap_max"]["limit"]
