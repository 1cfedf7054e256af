"""The port's block engine routing across two tiers — full width for short
blocks, a banded stored window for long banded blocks, the native engine
otherwise — against FusedPOA and FusedPallasEngine(interpret=True) on the
case of test_poa_pallas_win.test_engine_windowed_tiers_route_and_match."""
import numpy as np

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_fused import FusedPallasEngine
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine

from test_poa_pallas_win import family
from test_torch_engine import _oracle, _same_graph


def test_two_tier_routing_matches():
    """Full-width tier for short blocks, banded-window tier for long
    banded blocks, native engine otherwise."""
    eng = TorchPOAEngine(device="cpu",
                         tiers=((512, 256, 256), (1024, 768, 384)),
                         max_seqs=16)
    pal = FusedPallasEngine(tiers=((2, 512, 256, 256), (1, 1024, 768, 384)),
                            max_seqs=16, max_batch=4, interpret=True)
    rng = np.random.default_rng(31)
    p_short = POAParams(1, 4, 6, 2, 26, 1, local=True)
    p_long = POAParams(1, 4, 6, 2, 26, 1, local=False, wb=40, wf_milli=30)
    short = [family(rng, 80, 4), family(rng, 60, 3)]
    longb = [family(rng, 500, 4)]
    blocks = [(sq, [1] * len(sq), p_short) for sq in short] + \
             [(sq, [1] * len(sq), p_long) for sq in longb]
    assert eng._route(short[0], p_short) == 0
    assert eng._route(longb[0], p_long) == 1
    assert eng._route(longb[0], p_short) is None
    graphs = eng.poa_block_batch(blocks)
    ref = pal.poa_block_batch(blocks)
    for (sq, w, p), g, r in zip(blocks, graphs, ref):
        _same_graph(g, _oracle(sq, p))
        assert g.seq_paths == r.seq_paths and g._topo == r._topo
    assert eng.tier_blocks == {0: 2, 1: 1}
    assert eng.stats()["device_blocks"] == 3
