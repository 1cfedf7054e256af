"""The consensus-graph workers' FlatIndex cache
(smoothxg_tpu_torch/pipeline/consensus_graph.py:_worker_index, ROADMAP C5):
the `-t N` pool outlives a run, so a smoothed GFA rewritten at the same path
must be read again, not served from the index of the file it replaced."""
from smoothxg_tpu_torch.graph.index import FlatIndex
from smoothxg_tpu_torch.io.gfa import read_gfa
from smoothxg_tpu_torch.pipeline.consensus_graph import _worker_index
from smoothxg_tpu_torch.testing.synth import write_pangenome


def test_a_gfa_rewritten_at_the_same_path_gets_a_new_index(tmp_path):
    path = str(tmp_path / "smoothed.gfa")
    write_pangenome(path, haplotypes=2, length=1200, seed=1)
    first = _worker_index(path)
    assert _worker_index(path) is first        # unchanged file: cached
    write_pangenome(path, haplotypes=3, length=1500, seed=2)
    second = _worker_index(path)
    fresh = FlatIndex(read_gfa(path))
    assert second is not first
    assert second.path_count() == fresh.path_count() == 3
    assert second.n_nodes == fresh.n_nodes
    assert [second.path_seq(p) for p in range(3)] == \
        [fresh.path_seq(p) for p in range(3)]
