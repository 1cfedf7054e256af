"""Every run of the port maps a sequence index of its own (ROADMAP C18).

The pipeline serves path sequences from an mmap store written next to the
output.  Its name used to be `.seqindex_<iteration>.sqx` there, so two runs
whose outputs share a directory (one job per chromosome into one folder, as
pggb-style pipelines run) wrote and mapped the same file, and one run read
the other's sequences: lace's validation failed or, worse, passed on wrong
bytes.  Now the name is unique to the run (mkstemp in that directory, the
rank suffix kept).  Held here: two configurations whose outputs share a
directory get different index files, both wiped after their iteration
(kept with -K); and two CLI processes started at once on two generator
pangenomes, outputs in one directory, both validate and each writes its
solo run's bytes."""
import hashlib
import os
import subprocess
import sys

import pytest

from smoothxg_tpu_torch import cli
from smoothxg_tpu_torch.graph.seqindex import SeqIndex
from smoothxg_tpu_torch.pipeline.run import run_smoothing
from smoothxg_tpu_torch.testing.synth import write_pangenome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-j", "5k", "-e", "5k", "-t", "1", "--engine", "native"]
# (haplotypes, seed) of the two pangenomes, 20 kb each
FIXTURES = ((4, 3), (8, 4))


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    return [write_pangenome(str(d / f"pg{h}.gfa"), haplotypes=h,
                            length=20_000, seed=s) for h, s in FIXTURES]


def argv(gfa: str, out_dir: str, lengths: str = "700,900,1100") -> list:
    """The CLI's flags for `gfa` (-r its haplotype count), outputs named
    after it in `out_dir`."""
    tag = os.path.splitext(os.path.basename(gfa))[0]
    return ["-g", gfa, "-o", os.path.join(out_dir, f"{tag}.gfa"),
            "-m", os.path.join(out_dir, f"{tag}.maf"), "-r", tag[2:],
            "-l", lengths, *FLAGS]


@pytest.mark.parametrize("keep", [False, True])
def test_runs_into_one_directory_get_their_own_index(inputs, tmp_path,
                                                     monkeypatch, keep):
    """Two run_smoothing configurations whose outputs share a directory
    build their index under different names in that directory (one a POA
    iteration); each is removed after its iteration unless -K keeps it."""
    built = []
    build = SeqIndex.build

    def spy(idx, path):
        built.append(path)
        return build(idx, path)

    monkeypatch.setattr(SeqIndex, "build", staticmethod(spy))
    out = str(tmp_path)
    for gfa in inputs:
        args = cli.build_parser().parse_args(
            argv(gfa, out, "700") + (["-K"] if keep else []))
        run_smoothing(cli.config_from_args(
            args, add_consensus=not args.vanish_consensus), device="cpu")
    assert len(built) == 2 and built[0] != built[1]
    for path in built:
        assert os.path.dirname(path) == out
        assert os.path.basename(path).startswith(".seqindex_0.")
        assert os.path.exists(path) is keep


def test_concurrent_clis_into_one_directory_keep_their_own_bytes(
        inputs, tmp_path):
    """Two port CLIs started at once, outputs in one directory: both exit
    0 (lace validated every path against its own index) and each GFA and
    MAF equals its solo run's."""
    solo = []
    for k, gfa in enumerate(inputs):
        d = tmp_path / f"solo{k}"
        d.mkdir()
        solo.append(str(d))
    shared = tmp_path / "shared"
    shared.mkdir()

    def start(gfa, d):
        return subprocess.Popen(
            [sys.executable, "-m", "smoothxg_tpu_torch.cli",
             *argv(gfa, d)], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    for runs in ([start(g, d) for g, d in zip(inputs, solo)],
                 [start(g, str(shared)) for g in inputs]):
        for p in runs:
            log = p.communicate(timeout=120)[0]
            assert p.returncode == 0, log[-2000:]
    for gfa, d in zip(inputs, solo):
        tag = os.path.splitext(os.path.basename(gfa))[0]
        for ext in ("gfa", "maf"):
            assert sha256(os.path.join(d, f"{tag}.{ext}")) == \
                sha256(os.path.join(shared, f"{tag}.{ext}")), (tag, ext)
    assert not [f for f in os.listdir(shared) if f.endswith(".sqx")]
