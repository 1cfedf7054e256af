"""Block sharding of the port (smoothxg_tpu_torch/parallel/mesh.py and
TorchPOAEngine(devices=...)) and the multi-process helpers
(parallel/multiproc.py) on the CPU: a batch cut into contiguous shards on
["cpu", "cpu"] gives the results of one launch, bit for bit, and the
results of the JAX package's sharded round functions on a one-device CPU
mesh.  The Pallas round kernel's input arrays come from the JAX package's
own packing (PallasPOAEngine._pack), as the round module's tests build
them."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothxg_tpu.ops import poa_host as jax_host
from smoothxg_tpu.ops.poa_graph import POAGraph as JaxGraph
from smoothxg_tpu.ops.poa_pallas import PallasPOAEngine
from smoothxg_tpu.parallel import mesh as jax_mesh
from smoothxg_tpu_torch.graph.index import FlatIndex
from smoothxg_tpu_torch.io.gfa import read_gfa
from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_batch import pack_tasks, poa_batch
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine
from smoothxg_tpu_torch.ops.poa_round import (from_pallas_layout, poa_round,
                                              to_pallas_layout)
from smoothxg_tpu_torch.parallel.mesh import (dp_train_step, make_mesh,
                                              sharded_pallas_round,
                                              sharded_poa_round)
from smoothxg_tpu_torch.parallel.multiproc import (pack_results,
                                                   shard_bounds,
                                                   unpack_results)
from smoothxg_tpu_torch.pipeline.blocks import smoothable_blocks
from smoothxg_tpu_torch.pipeline.prep import prep
from smoothxg_tpu_torch.pipeline.smooth import smooth_blocks
from smoothxg_tpu_torch.testing.synth import write_pangenome

ALPHA = np.frombuffer(b"ACGT", np.uint8)
CPUS = ["cpu", "cpu"]


def mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r >= rate / 2:
            out.append(rng.choice(ALPHA) if r < rate else ch)
        if rng.random() < rate / 4:
            out.append(rng.choice(ALPHA))
    return np.array(out, np.uint8)


@functools.lru_cache(maxsize=None)
def tasks(local):
    """Five seeded (jax task, port task) pairs, so the two shards are
    uneven (3 + 2)."""
    rng = np.random.default_rng(31 + local)
    pj = jax_host.POAParams(local=local)
    pp = poa_host.POAParams(local=local)
    out = []
    for _ in range(5):
        base = rng.choice(ALPHA, int(rng.integers(20, 60)))
        fam = [base, mutate(rng, base, 0.08), mutate(rng, base, 0.08)]
        gj, gp = JaxGraph(), POAGraph()
        gj.add_sequence(fam[0], 1)
        gp.add_sequence(fam[0], 1)
        for s in fam[1:]:
            gj.add_alignment(jax_host.align(gj, s, pj), s, 1)
            gp.add_alignment(poa_host.align(gp, s, pp), s, 1)
        q = mutate(rng, base, 0.08)
        out.append(((gj, q, pj), (gp, q, pp)))
    return out


def equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("local", [True, False])
def test_sharded_poa_round_equals_one_launch(local):
    ins, _ = pack_tasks([t for _, t in tasks(local)])
    want = poa_batch(*ins, local)
    equal(sharded_poa_round(CPUS, *ins, local=local), want)
    equal(dp_train_step(["cpu"] * 3, *ins, local=local), want)


@pytest.mark.parametrize("local", [True, False])
def test_sharded_pallas_round_equals_one_launch(local):
    VW, LW, P = 256, 256, 4
    jt = [j for j, _ in tasks(local)]
    slen, nv, par, ninfo, seq, _ = PallasPOAEngine._pack(
        jt, list(range(len(jt))), VW, LW, P, len(jt))
    want = poa_round(*from_pallas_layout(slen, nv, par, ninfo, seq, P),
                     local)
    got = sharded_pallas_round(CPUS, slen, nv, par, ninfo, seq, VW=VW,
                               LW=LW, P=P, local=local)
    equal(got, want)
    assert int(want[1][:, 0].min()) > 0


@pytest.mark.parametrize("local", [True, False])
def test_sharded_rounds_equal_the_jax_package_on_one_device(local):
    """The port's two sharded round functions on ["cpu", "cpu"] against the
    JAX package's on a one-device CPU mesh (the Pallas kernel in interpret
    mode), on the same packed arrays: out, outpos and bv bit for bit, and
    the Pallas layout's meta and moves."""
    mesh = jax_mesh.make_mesh(1)
    ins, _ = pack_tasks([t for _, t in tasks(local)])
    want = jax_mesh.sharded_poa_round(
        mesh, *(jnp.asarray(x.numpy()) for x in ins), local=local)
    got = sharded_poa_round(CPUS, *ins, local=local)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(
            np.asarray(w).astype(np.int32)))
    VW, LW, P = 256, 256, 4
    jt = [j for j, _ in tasks(local)]
    slen, nv, par, ninfo, seq, _ = PallasPOAEngine._pack(
        jt, list(range(len(jt))), VW, LW, P, len(jt))
    codes, meta = (np.asarray(x) for x in jax_mesh.sharded_pallas_round(
        mesh, *(jnp.asarray(x) for x in (slen, nv, par, ninfo, seq)),
        VW=VW, LW=LW, P=P, local=local, interpret=True))
    pc, pm = to_pallas_layout(*sharded_pallas_round(
        CPUS, slen, nv, par, ninfo, seq, VW=VW, LW=LW, P=P, local=local),
        VW + LW + 8)
    assert pm.tolist() == meta.tolist()
    for b in range(len(jt)):
        n = int(meta[b, 0])
        assert n > 0 and meta[b, 2] == 0
        assert pc[b, :n].tolist() == codes[b, :n].tolist()


def _blocks(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.choice(ALPHA, int(rng.integers(60, 120)))
        out.append([base] + [mutate(rng, base, 0.05) for _ in range(2)])
    return out


@pytest.mark.parametrize("kernel", ["win", "code", "stacked"])
def test_engine_shards_equal_one_shard(kernel):
    """TorchPOAEngine(devices=[cpu, cpu]) against one shard, each of the
    three whole-block kernels (their plain versions on the CPU)."""
    kw = ({"shape": (512, 256)} if kernel == "code" else
          {"kernel": "stacked", "tiers": ((512, 256, 256),)}
          if kernel == "stacked" else {"tiers": ((512, 256, 256),)})
    p = poa_host.POAParams(local=True)
    blocks = [(sq, [1] * len(sq), p) for sq in _blocks(11, 3)]
    one = TorchPOAEngine(device="cpu", **kw)
    two = TorchPOAEngine(device="cpu", devices=CPUS, **kw)
    assert one.devices == [torch.device("cpu")] and len(two.devices) == 2
    a, b = one.poa_block_batch(blocks), two.poa_block_batch(blocks)
    for ga, gb in zip(a, b):
        assert ga.base == gb.base and ga.seq_paths == gb.seq_paths
    assert one.stats()["device_blocks"] == two.stats()["device_blocks"] == 3
    assert one.stats()["calls"] == two.stats()["calls"] == 1


def test_make_mesh():
    assert make_mesh(CPUS) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA required"):
            make_mesh(1)


@pytest.mark.parametrize("n,size", [(0, 2), (5, 2), (7, 3), (3, 4),
                                    (100, 7)])
def test_shard_bounds_cover_the_range(n, size):
    b = [shard_bounds(n, r, size) for r in range(size)]
    assert b[0][0] == 0 and b[-1][1] == n
    assert all(b[r][1] == b[r + 1][0] for r in range(size - 1))
    lens = [hi - lo for lo, hi in b]
    assert max(lens) - min(lens) <= 1 and lens == sorted(lens, reverse=True)


def test_pack_and_unpack_results_round_trip(tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=5)
    idx = FlatIndex(prep(read_gfa(gfa), 100, use_sgd=False))
    bs = smoothable_blocks(idx, 700 * 4, 700, 5000, 5000)
    results = smooth_blocks(
        idx, bs, params=poa_host.POAParams(local=True),
        engine=NativePOAEngine(), consensus_base_name="Consensus_",
        produce_maf=True)
    assert len(results) > 1
    back = unpack_results(pack_results(results))
    assert len(back) == len(results)
    for a, b in zip(results, back):
        assert (a.block_id, a.consensus_name, a.path_mappings,
                a.groom_flip) == (b.block_id, b.consensus_name,
                                  b.path_mappings, b.groom_flip)
        ga, gb = a.get_graph(), b.get_graph()
        assert ga.path_names == gb.path_names
        for x, y in zip(ga.to_arrays(), gb.to_arrays()):
            assert (x == y).all()
        assert a.maf == b.maf
