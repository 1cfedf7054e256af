"""The port's CUDA kernels on the GPU: each kernel (poa_win, poa_round,
poa_batch, poa_code and poa_stacked at every profiling stage, the four probe
families of csrc/probes.cu, sgd.cu, minhash.cu's two entries and
ident.cu) against its plain PyTorch version (exact equality: the POA,
probe and split outputs are integers, and sgd.cu sums in the plain
version's order) and each GPU engine's slice end to end
against the native engine's bytes, and a launch sharded over two
streams of one card against one launch.  Every test needs an NVIDIA GPU and
skips without one.  Nothing here imports jax, so on a GPU machine without
it: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""
import hashlib

import numpy as np
import pytest
import torch

from smoothxg_tpu.pipeline.run import Config as JaxConfig
from smoothxg_tpu.pipeline.run import run_smoothing as jax_pkg_run
from smoothxg_tpu_torch.ops import poa_batch as pb
from smoothxg_tpu_torch.ops.poa_code import (CodeCaps, poa_code,
                                             poa_code_reference)
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_round import (TorchRoundPOAEngine,
                                              decode_moves, pack_tasks,
                                              poa_round, poa_round_reference)
from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked,
                                                poa_stacked_reference,
                                                stacked_caps)
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks, poa_win,
                                            poa_win_reference)
from smoothxg_tpu_torch.parallel.mesh import sharded_poa_round
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import (make_block, make_fan_in_block,
                                              make_fan_in_task,
                                              make_round_task,
                                              write_pangenome)
from smoothxg_tpu_torch.tools import _probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("local,banded", [(True, False), (False, False),
                                          (False, True)])
def test_kernel_matches_plain_version(cuda_device, local, banded):
    rng = np.random.default_rng(29)
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=40 if banded else -1)
    blocks = [(make_block(rng, 300 + 40 * i, 3 + i % 3, 0.02), p)
              for i in range(6)]
    VW, LW, W = (2048, 1024, 512) if banded else (1024, 512, 512)
    ins = pack_blocks(blocks, LW)
    caps = WinCaps(VW, LW, W, local, banded)
    before = poa_win.launches
    got = poa_win(*(x.to(cuda_device) for x in ins), caps)
    torch.cuda.synchronize()
    assert poa_win.launches == before + 1
    want = poa_win_reference(*ins, caps)
    assert int(want[0][:, 1].sum()) == 0, "fixture overflows"
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# kernel: (wrapper, plain version, caps, in-degree held, overflowing)
CHASE = {"poa_code": (poa_code, poa_code_reference, CodeCaps, 8, 9),
         "poa_stacked": (poa_stacked, poa_stacked_reference, stacked_caps,
                         4, 5)}


@pytest.mark.parametrize("local,banded", [(True, False), (False, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("name", sorted(CHASE))
def test_chase_kernel_matches_plain_version(cuda_device, name, local,
                                            banded):
    """Seeded blocks, a fan-in the kernel holds and one that overflows
    it, banded (abPOA band narrower than the rows) or not; 140 blocks in
    one launch, so poa_stacked packs 2 warps per thread block."""
    kern, ref, mkcaps, held, over = CHASE[name]
    rng = np.random.default_rng(53)
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=12 if banded else -1)
    blocks = [make_block(rng, int(rng.integers(20, 60)), 2 + i % 3, 0.05)
              for i in range(134)]
    blocks += [make_block(rng, 300 + 60 * i, 3, 0.03) for i in range(4)]
    blocks += [make_fan_in_block(rng, held, 40),
               make_fan_in_block(rng, over, 40)]
    ins = pack_blocks([(sq, p) for sq in blocks], 1024)
    caps = mkcaps(2048, 1024, local, banded)
    before = kern.launches
    got = kern(*(x.to(cuda_device) for x in ins), caps)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = ref(*ins, caps)
    assert want[0][:, 1].tolist() == [0] * 139 + [1]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("name", sorted(CHASE))
def test_chase_kernel_stages_match_plain_version(cuda_device, name, local):
    """Every profiling stage of poa_code (0-7) and poa_stacked (0-2) on
    seeded blocks: stage 0 is the kernel itself, the other stages equal
    their plain versions (graphs invalid by design, but deterministic)."""
    from smoothxg_tpu_torch.ops import poa_code as pc, poa_stacked as ps
    kern, ref, mkcaps, _, _ = CHASE[name]
    stages = pc.STAGES if name == "poa_code" else ps.STAGES
    rng = np.random.default_rng(57)
    p = POAParams(local=local)
    blocks = [make_block(rng, 100 + 40 * i, 3 + i % 3, 0.03)
              for i in range(5)]
    ins = pack_blocks([(sq, p) for sq in blocks], 512)
    caps = mkcaps(1024, 512, local, False)
    for st in stages:
        got = kern(*(x.to(cuda_device) for x in ins), caps, stage=st)
        torch.cuda.synchronize()
        want = ref(*ins, caps, st)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), f"stage {st}"


def _probe_cases(family):
    cases = {"scalar": [_probe.Case(k, "scalar", k) for k in _probe.SCALAR]
             + [_probe.Case("chase32k", "scalar", "chase", sz=32768)],
             "row": [_probe.Case(k, "row", k) for k in _probe.ROW],
             "tile": [_probe.Case(k, "tile", k) for k in _probe.TILE],
             "step": [_probe.Case(f"K={k}", "step", k)
                      for k in _probe.STEP_KS]}
    return cases[family]


@pytest.mark.parametrize("family", ["scalar", "row", "tile", "step"])
def test_probe_kernels_match_plain_versions(cuda_device, family):
    """Every case and variant of a probe family at 5,000 steps (the
    224 KiB table set in shared memory among them)."""
    wrapper = _probe.WRAPPERS[f"probe_{family}"]
    before = wrapper.launches
    nvar = 0
    for case in _probe_cases(family):
        assert _probe.check(case, cuda_device)[0] == 0, case.name
        nvar += len(case.variants)
    torch.cuda.synchronize()
    assert wrapper.launches == before + nvar


@pytest.mark.parametrize("local", [True, False])
def test_round_kernel_matches_plain_version(cuda_device, local):
    """Seeded round tasks up to ~1 kb, a node of in-degree 12 and an empty
    slot in one launch; decoded moves equal the oracle's."""
    rng = np.random.default_rng(41)
    p = POAParams(local=local)
    tasks = [make_round_task(rng, 200 + 160 * i, 3 + i % 5, 0.03, p)
             for i in range(6)]
    tasks += [make_fan_in_task(rng, 12, 150, p), (POAGraph(), tasks[0][1], p)]
    ins, orders = pack_tasks(tasks)
    before = poa_round.launches
    got = poa_round(*(x.to(cuda_device) for x in ins), local)
    torch.cuda.synchronize()
    assert poa_round.launches == before + 1
    want = poa_round_reference(*ins, local)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    codes, meta = want
    assert (meta[:, 2] == 0).all()
    for b, t in enumerate(tasks):
        assert decode_moves(codes[b].numpy(), int(meta[b, 0]), orders[b]) \
            == poa_host.align(*t)


@pytest.mark.parametrize("local", [True, False])
def test_batch_kernel_matches_plain_version(cuda_device, local):
    """poa_batch (--engine jax) on seeded round tasks and a node of
    in-degree 12 (P = 16), against its plain version; the same launch
    sharded over two streams of the card gives the same outputs."""
    rng = np.random.default_rng(43)
    p = POAParams(local=local)
    tasks = [make_round_task(rng, 200 + 160 * i, 3 + i % 5, 0.03, p)
             for i in range(6)]
    tasks.append(make_fan_in_task(rng, 12, 150, p))
    ins, _ = pb.pack_tasks(tasks)
    assert ins[1].shape[2] == 16
    before = pb.poa_batch.launches
    got = pb.poa_batch(*(x.to(cuda_device) for x in ins), local)
    torch.cuda.synchronize()
    assert pb.poa_batch.launches == before + 1
    want = pb.poa_batch_reference(*ins, local)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    dev = torch.device("cuda", torch.cuda.current_device())
    for g, w in zip(sharded_poa_round([dev, dev], *ins, local=local), want):
        assert torch.equal(g.cpu(), w)


def test_round_kernel_past_the_pallas_packing(cuda_device):
    """A query longer than 2^15 (read from global memory, not shared) that
    ends in the graph's sequence: 64-bit codes past the Pallas packing."""
    rng = np.random.default_rng(43)
    p = POAParams(local=True)
    g, q, _ = make_round_task(rng, 200, 2, 0.03, p)
    q = np.concatenate([rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                   1 << 15), q])
    ins, orders = pack_tasks([(g, q, p)])
    got = poa_round(*(x.to(cuda_device) for x in ins), True)
    want = poa_round_reference(*ins, True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    codes, meta = want
    assert int(codes[0, 0] & 0xFFFFFFFF) >= 1 << 15
    assert decode_moves(codes[0].numpy(), int(meta[0, 0]), orders[0]) == \
        poa_host.align(g, q, p)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cfg(gfa, tmp, tag, engine, config=Config):
    return config(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
                  write_msa_in_maf_format=str(tmp / f"{tag}.maf"),
                  n_haps=4, max_path_jump=5000, max_edge_jump=5000,
                  poa_length_targets=[700], threads=1, add_consensus=True,
                  tmp_base=str(tmp), engine=engine)


def test_slice_on_gpu_matches_native_bytes(cuda_device, tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = TorchPOAEngine(device=cuda_device)
    eng.warmup(locals_=(True, False), banded=(False, True))
    assert eng.stats()["kernel_launches"] == 4
    run_smoothing(_cfg(gfa, tmp_path, "port", "fused"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    assert eng.stats()["kernel_launches"] > 4
    assert eng.stats()["device_blocks"] > 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


@pytest.mark.parametrize("option", ["shape", "stacked"])
def test_chase_slices_on_gpu_match_native_bytes(cuda_device, tmp_path,
                                                option):
    """TorchPOAEngine(shape=...) runs every block on poa_code,
    TorchPOAEngine(kernel="stacked") on poa_stacked; both give the native
    engine's bytes."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = TorchPOAEngine(device=cuda_device, shape=(4352, 2048)) \
        if option == "shape" else \
        TorchPOAEngine(device=cuda_device, kernel="stacked")
    kern = poa_code if option == "shape" else poa_stacked
    before = (kern.launches, poa_win.launches)
    run_smoothing(_cfg(gfa, tmp_path, "port", "fused"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    st = eng.stats()
    assert kern.launches > before[0] and poa_win.launches == before[1]
    assert st["kernel_launches"] == kern.launches - before[0]
    assert st["device_blocks"] > 0 and st["fallbacks"] == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


def test_round_slice_on_gpu_matches_native_bytes(cuda_device, tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = TorchRoundPOAEngine(device=cuda_device)
    eng.warmup(locals_=(True, False))
    assert eng.stats()["kernel_launches"] == 2
    run_smoothing(_cfg(gfa, tmp_path, "port", "pallas"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    st = eng.stats()
    assert st["kernel_launches"] > 2 and st["device_tasks"] > 0
    assert st["fallbacks"] == 0 and st["stuck_fallbacks"] == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


def test_sgd_kernel_matches_plain_version(cuda_device, tmp_path):
    """csrc/sgd.cu against its plain versions on the card, two iterations
    of draws from one generator: the plan kernel's words equal to
    sgd_plan_reference's and the chain kernel's x to sgd_reference's, bit
    for bit; the plan of the second iteration applied again to the first
    x gives the plain version's x there too."""
    from smoothxg_tpu_torch.io.gfa import read_gfa
    from smoothxg_tpu_torch.ops import sgd
    g = read_gfa(write_pangenome(str(tmp_path / "in.gfa"), haplotypes=8,
                                 length=20_000, seed=5))
    prob = sgd.sgd_problem(g)
    arr = prob.tensors(cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    x = torch.from_numpy(prob.x0.astype(np.float32)).to(cuda_device)
    xk = x.clone()
    before = sgd.sgd_iter.launches, sgd.sgd_plan.launches
    x_first = x.clone()
    for eta, cap in zip(prob.etas(2), (prob.zipf_space, 1000)):
        ins = (*sgd.sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"], cap),
               arr["node"], arr["pos"], arr["start"], arr["count"],
               float(eta))
        plan = sgd.sgd_plan(*ins)
        assert torch.equal(plan, sgd.sgd_plan_reference(*ins))
        sgd.sgd_iter(xk, *ins, plan=plan)
        sgd.sgd_reference(x, *ins)
        assert torch.equal(xk, x)
    assert torch.equal(sgd.sgd_iter(x_first.clone(), *ins, plan=plan),
                       sgd.sgd_reference(x_first.clone(), *ins))
    assert (sgd.sgd_iter.launches, sgd.sgd_plan.launches) == \
        (before[0] + 3, before[1] + 2)


def test_split_kernels_match_plain_versions(cuda_device):
    """csrc/minhash.cu's two entries and csrc/ident.cu against their plain
    versions on the card (exact), and the distances and identities of
    their classes against the numpy mirrors."""
    from smoothxg_tpu_torch.ops import ident_cuda as ic
    from smoothxg_tpu_torch.ops import minhash_cuda as mc
    rng = np.random.default_rng(3)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 900))
    seqs = [base[i:] + base[:i] for i in range(0, 300, 20)]
    seqs += [mc.SENTINEL_KMER + base, "ACGT" * 30, ""]
    codes, lens = (torch.from_numpy(a).to(cuda_device)
                   for a in mc.encode_batch(seqs))
    want = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, 16))
    for route in (mc.minhash_hash, mc.minhash_hash_long):
        hs, counts = route(codes, lens, 16)
        assert torch.equal(hs, want[0]) and torch.equal(counts, want[1])
    ref = mc.minhash_inter_reference(hs, counts,
                                     *mc.triu_pairs(len(seqs), cuda_device))
    assert torch.equal(mc.minhash_inter(hs, counts), ref)
    assert torch.equal(mc.minhash_inter_long(hs, counts), ref)
    assert np.array_equal(
        mc.DeviceMinHash(16, device=cuda_device).distance_matrix(seqs),
        mc.host_distance_matrix(seqs, 16))
    pairs = [(s, seqs[0]) for s in seqs] + [(base, base[:400] + base[500:])]
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n].to(cuda_device)
           for n in ("a", "aoff", "la", "b", "boff", "lb")]
    for band in (128, 32, 64, 96, 256, 288):     # warp kernel to 256
        assert torch.equal(ic.ident_counts(*ins, band),
                           ic.ident_counts_reference(*ins, band))
    assert ic.DeviceBandedIdentity(device=cuda_device).identities(pairs) == \
        [ic.host_banded_identity(a, b) for a, b in pairs]


def test_jax_slice_on_gpu_matches_native_bytes(cuda_device, tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = pb.TorchBatchPOAEngine(device=cuda_device)
    run_smoothing(_cfg(gfa, tmp_path, "port", "jax"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    st = eng.stats()
    assert st["kernel_launches"] > 0 and st["device_tasks"] > 0
    assert st["fallbacks"] == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")
