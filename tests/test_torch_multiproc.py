"""Multi-process runs of the port (smoothxg_tpu_torch/parallel/multiproc.py):
two ranks of the port's CLI joined by torch.distributed (gloo, a free local
port) give the GFA and MAF bytes of one rank and of the JAX package's CLI,
and only rank 0 writes them.  The ranks run --engine native with -t 2;
their SGD prep is forced to one thread, so the one-rank runs are at -t 1.
The bootstrap (parallel/mesh.init_distributed) and the two-step byte
gather are also driven alone, in two plain processes."""
import hashlib
import os
import subprocess
import sys

import torch.distributed as dist

from smoothxg_tpu import cli as jax_cli
from smoothxg_tpu_torch import cli
from smoothxg_tpu_torch.parallel.mesh import init_distributed
from smoothxg_tpu_torch.testing.ranks import ROOT, free_port, run_ranks
from smoothxg_tpu_torch.testing.synth import write_pangenome

FLAGS = ["-r", "4", "-l", "700", "--engine", "native"]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_two_ranks_give_the_bytes_of_one(tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=3)
    one, one_maf = str(tmp_path / "one.gfa"), str(tmp_path / "one.maf")
    assert cli.run(["-g", gfa, "-o", one, "-m", one_maf, *FLAGS,
                    "-t", "1"])[0] == 0
    two, two_maf = str(tmp_path / "two" / "o.gfa"), str(tmp_path / "two" /
                                                         "o.maf")
    os.makedirs(tmp_path / "two")
    res = run_ranks(["-g", gfa, "-o", two, "-m", two_maf, *FLAGS, "-t", "2"],
                    2, timeout=300)
    for rc, err in res:
        assert rc == 0, err[-2000:]
    assert "forcing deterministic sequential SGD prep" in res[1][1]
    assert "all-gather payload" in res[0][1]
    assert _sha(two) == _sha(one) and _sha(two_maf) == _sha(one_maf)
    ref, ref_maf = str(tmp_path / "jax.gfa"), str(tmp_path / "jax.maf")
    assert jax_cli.main(["-g", gfa, "-o", ref, "-m", ref_maf, *FLAGS,
                         "-t", "1"]) == 0
    assert _sha(two) == _sha(ref) and _sha(two_maf) == _sha(ref_maf)
    # rank 1 left no output of its own in the shared directory
    assert sorted(os.listdir(tmp_path / "two")) == ["o.gfa", "o.maf"]


def test_a_failing_rank_ends_the_run(tmp_path):
    """A rank that cannot start (its input is missing) exits 1, and the
    other, left waiting for it in the process group, is ended."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=2,
                          length=500, seed=1)
    res = run_ranks(["-o", str(tmp_path / "o.gfa"), "-r", "2", "--engine",
                     "native"], 2, timeout=120,
                    per_rank=lambda r: ["-g", gfa if r == 0 else
                                        str(tmp_path / "absent.gfa")])
    assert res[1][0] == 1
    assert res[0][0] != 0
    assert not os.path.exists(tmp_path / "o.gfa")


GATHER = """
import sys
from smoothxg_tpu_torch.parallel.mesh import init_distributed
from smoothxg_tpu_torch.parallel.multiproc import allgather_bytes
r = int(sys.argv[2])
init_distributed(sys.argv[1], 2, r)
print(b"|".join(allgather_bytes(b"r%d" % r * (1 + 3 * r))).decode())
"""


def test_init_distributed_joins_two_processes():
    """init_distributed(coordinator, 2, r) in two processes makes one gloo
    group, and allgather_bytes gives both the payloads of unequal lengths
    in rank order.  With one process it starts no group."""
    coord = f"localhost:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", GATHER, coord, str(r)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        res = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "r0|r1r1r1r1"
    init_distributed(coord, 1, 0)
    assert not dist.is_initialized()
