"""The other kernel sources, csrc/probes.cu, sgd.cu, minhash.cu, ident.cu
and autocorr.cu, built for the CUDA emulation under AddressSanitizer and
UBSan (cuda_emu.build(..., sanitize=True)) and run on the inputs of their
emulation tests, held to their plain PyTorch versions (exact: sgd.cu sums
in the plain version's order, the rest are integers).  The emulated shared
memory is exactly the launch's bytes, and any sanitizer report ends the
launch nonzero, which the run_* helpers raise with the report as the
message.  Each source runs its routes: a kernel of each probe family; the
SGD plan and the cluster chain (whose blocks reach each other's shared
memory); MinHash's hash step in shared and in device memory and its
intersections by tiles and by the long route; ident's warp and block
kernels; autocorr's units staged in shared memory and read from device
memory.  (The POA sources: test_torch_sanitize_emu.py.)"""
import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.io.gfa import read_gfa
from smoothxg_tpu_torch.ops import autocorr as ac
from smoothxg_tpu_torch.ops import ident_cuda as ic
from smoothxg_tpu_torch.ops import minhash_cuda as mc
from smoothxg_tpu_torch.ops import sgd
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import write_pangenome
from smoothxg_tpu_torch.tools import _probe as P

SOURCES = ("probes", "sgd", "minhash", "ident", "autocorr")


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    return cuda_emu.build_many(SOURCES, str(tmp_path_factory.mktemp("asan")),
                               sanitize=True)


def _probes(exe, tmp_path):
    """test_torch_probes.py's cases, one of each family (the scalar chase
    over a 4,096-word table)."""
    for fam, args, n, inp, want in (
            ("scalar", (P.SCALAR.index("chase"), P.MEMS.index("shared")),
             500, None, P.scalar_reference("chase", 500, 4096)),
            ("row", (P.ROW.index("mread"), P.MEMS.index("shared"), 32), 300,
             P.plane7(), P.row_reference("mread", 300, P.plane7())),
            ("tile", (P.TILE.index("fillrow"),), 300, P.plane11(),
             P.tile_reference("fillrow", 300, P.plane11())),
            ("step", (P.LAYOUTS.index("warp"), 4), 300, P.stack_plane(4),
             P.step_reference(4, 300, P.stack_plane(4)))):
        got = cuda_emu.run_probe(exe, fam, args, n, sz=4096, inp=inp)
        assert torch.equal(got, want), fam


def _sgd(exe, tmp_path):
    """test_torch_sgd.py's one minibatch on the 8 x 20 kb graph: the plan
    kernel and the cluster chain, bit for bit."""
    g = read_gfa(write_pangenome(str(tmp_path / "g.gfa"), haplotypes=8,
                                 length=20_000, seed=5)).compact()
    prob = sgd.sgd_problem(g)
    arr = prob.tensors(torch.device("cpu"))
    i1, z, sgn = sgd.sgd_draws(torch.Generator().manual_seed(4), prob.T,
                               sgd.MINIBATCH, arr["cdf"], prob.zipf_space)
    ins = (i1, z, sgn, arr["node"], arr["pos"], arr["start"],
           arr["count"], float(prob.etas(1)[0]))
    x0 = torch.from_numpy(prob.x0.astype(np.float32))
    want = sgd.sgd_reference(x0.clone(), *ins)
    x, plan = cuda_emu.run_sgd(exe, x0, *ins, timeout=240)
    assert torch.equal(plan, sgd.sgd_plan_reference(*ins))
    assert torch.equal(x, want)


def _minhash(exe, tmp_path):
    """test_torch_minhash.py's k16 case: the hash step on both routes, the
    intersections by tiles of 3 rows and by the long route."""
    rng = np.random.default_rng(16)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
    seqs = [base, base[:300] + "A" + base[300:], base[::-1],
            mc.SENTINEL_KMER + base[:200], "ACGT" * 3]
    codes, lens = (torch.from_numpy(a) for a in mc.encode_batch(seqs))
    want = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, 16))
    for device_keys in (False, True):
        hs, counts = cuda_emu.run_minhash_hash(exe, codes, lens, 16,
                                               device_keys)
        assert torch.equal(hs, want[0]) and torch.equal(counts, want[1])
    ref = mc.minhash_inter_reference(*want, *mc.triu_pairs(len(seqs)))
    for rows in (3, 0):
        assert torch.equal(cuda_emu.run_minhash_inter(exe, *want, rows), ref)


def _ident(exe, tmp_path):
    """test_torch_ident.py's pairs: the warp kernel (band 128) and the
    block kernel (band 288)."""
    rng = np.random.default_rng(3)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 260))
    pairs = [(base, base[:100] + "TT" + base[100:]), (base, base[40:]),
             (base[:90], base), ("ACGT" * 40, ""), ("", ""), ("A", "T")]
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n] for n in ("a", "aoff", "la", "b", "boff", "lb")]
    for band in (128, 288):
        got = cuda_emu.run_ident(exe, *ins, band=band, timeout=240)
        assert torch.equal(got, ic.ident_counts(*ins, band))


def _autocorr(exe, tmp_path):
    """test_torch_autocorr.py's rows of lengths 0-600 with N, lower case
    and garbage padding, at every lag residue: units staged in shared
    memory, then every unit read from device memory (a small emulated
    shared memory)."""
    rng = np.random.default_rng(5)
    lens = np.array([0, 1, 3, 4, 5, 9, 100, 255, 256, 257, 600, 130],
                    np.int32)
    alpha = np.frombuffer(b"ACGTNacgtn", np.uint8)
    rows = np.random.default_rng(6).integers(0, 256, (len(lens), 601)) \
        .astype(np.uint8)
    for b, n in enumerate(lens):
        rows[b, :n] = rng.choice(alpha[:5] if b % 2 else alpha, n)
    rows[11, :] = np.tile(np.frombuffer(b"ACGTA", np.uint8), 601)[:601]
    lags = np.array(list(range(1, 13)) + [63, 64, 65, 127, 128, 129, 255,
                                          256, 257, 450, 599, 600, 5000],
                    np.int32)
    rows, lens, lags = (torch.from_numpy(x) for x in (rows, lens, lags))
    want = ac.autocorr_counts_reference(rows, lens, lags)
    device_units = []
    for smem_block in (cuda_emu.SMEM_BLOCK, 256):
        got, _, plan = cuda_emu.run_autocorr(exe, ac.word_rows(rows), lens,
                                             lags, smem_block=smem_block,
                                             timeout=240)
        assert torch.equal(got, want)
        device_units.append(plan["device_units"])
    assert device_units[0] == 0 < device_units[1]


CASES = {"probes": _probes, "sgd": _sgd, "minhash": _minhash,
         "ident": _ident, "autocorr": _autocorr}


@pytest.mark.parametrize("name", SOURCES)
def test_sanitized_source_matches_plain_version(exes, name, tmp_path):
    CASES[name](exes[name], tmp_path)
