"""The port's host steal and background warm-up (smoothxg_tpu_torch/ops/
poa_engine.py:TorchPOAEngine) against FusedPallasEngine's
(smoothxg_tpu/ops/poa_pallas_fused.py): `_select_steal` picks the same
blocks from the same candidates and rates in the three regimes of the JAX
package's own test (tests/test_threads.py); a forced steal on the CPU gives
the graphs of the steal-off engine and of the native engine; a warm-up that
fails reaches the caller; make_engine's CPU warm-up finishes; the device
rate leaves out a call that waited for the warm-up."""
import threading
import time

import numpy as np
import pytest

from smoothxg_tpu.ops.poa_pallas_fused import FusedPallasEngine
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine
from smoothxg_tpu_torch.pipeline.run import Config, make_engine


def _blocks(n, L=256, reads=4, seed=3):
    """n blocks of `reads` random sequences of L bases."""
    rng = np.random.default_rng(seed)
    p = POAParams(local=True)
    return [([rng.integers(65, 69, L).astype(np.uint8)
              for _ in range(reads)], [1] * reads, p) for _ in range(n)]


# (device rows/s, host cells/s a worker) and the stolen count's range: a
# free card, a dead card, and rates that make one block of 256 bases cost
# the same on either side (tests/test_threads.py's three regimes)
L = 256.0
REGIMES = [((1e9, 1e6), (0, 1)), ((1e2, 1e12), (30, 32)),
           ((3 * L * 4, 3 * L * L * 4 / 3), (10, 22))]


@pytest.mark.parametrize("rates,bounds", REGIMES)
def test_select_steal_equals_the_reference(rates, bounds):
    """The same blocks, the same dev dict (the reference's legacy tier,
    K = 1, under two variants) and the same rates."""
    blocks = _blocks(32, reads=4)
    ref = FusedPallasEngine(interpret=True, max_batch=4, threads=4,
                            devices=1)
    port = TorchPOAEngine(device="cpu", threads=4, max_batch=4)
    got = {}
    for name, eng in (("ref", ref), ("port", port)):
        eng._dev_rows_ps, eng._host_cells_ps = rates
        dev = {(True, False, 0): list(range(0, 32, 2)),
               (False, False, 0): list(range(1, 32, 2))}
        got[name] = (eng._select_steal(blocks, dev), dev)
    assert got["port"] == got["ref"]
    stolen, dev = got["port"]
    assert bounds[0] <= len(stolen) <= bounds[1]
    assert len(stolen) + sum(map(len, dev.values())) == 32


def test_steal_defaults():
    eng = TorchPOAEngine(device="cpu", threads=4)
    assert eng.steal is False            # the CPU plain versions
    assert eng.max_batch == TorchPOAEngine.MAX_BATCH["win"]
    assert TorchPOAEngine(device="cpu", kernel="stacked").max_batch == 1056
    small = TorchPOAEngine(device="cpu", max_batch=3)
    assert small._tier_batch(0, False, 100) == 3
    st = eng.stats()
    assert st["stolen"] == 0
    assert st["host_cells_per_s"] == TorchPOAEngine.NATIVE_CELLS_PS
    assert st["dev_rows_per_s"] == TorchPOAEngine.DEV_ROWS_PS


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert list(ga.base) == list(gb.base)
        assert [list(p) for p in ga.seq_paths] == \
            [list(p) for p in gb.seq_paths]


def test_forced_steal_gives_the_same_graphs():
    """threads=2 (one pool worker counted), max_batch 4 under 10 blocks,
    and rates at which a block costs the same on either side: part of the
    blocks run on the pool, and every graph equals the steal-off engine's
    and the native engine's."""
    blocks = _blocks(10, L=40, reads=3, seed=5)
    eng = TorchPOAEngine(device="cpu", threads=2, max_batch=4, steal=True)
    nat, du = (sum(eng._steal_costs(b[0])[k] for b in blocks) for k in (0, 1))
    eng._dev_rows_ps, eng._host_cells_ps = 1.0, nat / du
    got = eng.poa_block_batch(blocks)
    assert 0 < eng.stolen < len(blocks)
    assert eng.stolen + eng.device_blocks == len(blocks)
    assert eng.stats()["stolen"] == eng.stolen
    off = TorchPOAEngine(device="cpu", threads=2, max_batch=4, steal=False)
    _same_graphs(got, off.poa_block_batch(blocks))
    assert off.stolen == 0 and off.device_blocks == len(blocks)
    _same_graphs(got, NativePOAEngine().poa_block_batch(blocks))


def test_the_gate_holds_small_calls_on_the_device():
    blocks = _blocks(4, L=40, reads=3)
    eng = TorchPOAEngine(device="cpu", threads=2, max_batch=4, steal=True)
    eng._dev_rows_ps, eng._host_cells_ps = 1e-3, 1e12    # steal everything
    eng.poa_block_batch(blocks)
    assert eng.stolen == 0 and eng.device_blocks == 4


def test_warmup_failure_reaches_the_caller():
    eng = TorchPOAEngine(device="cpu")

    def boom(*a, **k):
        raise RuntimeError("nvcc failed on csrc/poa_win.cu")

    eng.warmup = boom
    eng.warmup_async()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eng.poa_block_batch(_blocks(2, L=40))


def test_a_call_that_waits_for_the_warmup_is_fresh():
    eng = TorchPOAEngine(device="cpu")
    go = threading.Event()
    eng.warmup = lambda *a, **k: go.wait(10)
    eng.warmup_async()
    threading.Timer(0.2, go.set).start()
    blocks = _blocks(2, L=40)
    eng.poa_block_batch(blocks)
    assert eng._fresh is True
    eng.poa_block_batch(blocks)
    assert eng._fresh is False


def test_make_engine_warms_up_in_the_background():
    t0 = time.perf_counter()
    eng = make_engine(Config(engine="fused"), device="cpu")
    assert isinstance(eng, TorchPOAEngine)
    eng._warm_thread.join(10)
    assert not eng._warm_thread.is_alive() and eng._warm_error is None
    assert time.perf_counter() - t0 < 10
    assert eng.stats()["kernel_launches"] == 0      # no card, no launch
    got = eng.poa_block_batch(_blocks(2, L=40))
    assert eng.device_blocks == 2 and len(got) == 2
