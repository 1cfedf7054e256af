"""The control of `poa_gap_max`: the plain fill put in the program's place
in the 16-bit precision below the program's int32 (float16; int16 holds
every score of these blocks exactly, so it would be no control), its
alignment traced back through its own rounding and scored exactly.  It
has to read above the configuration's limit, where the program reads
under it.  On the CPU at the tiny size; on the card at the cells' own
size, where `python -m pytest -s` prints each seed's readings as a JSON
line.  The control is read over a pick in every block and the largest
(`sample_pairs(least=0)`): its traceback runs on the host, a second or so
a pick at the cells' size, and a run's further picks could only read it
higher."""
import json
import os
import time

import numpy as np
import pytest
import torch

from port_bench import spec
from port_bench.reference import judge, seqs


def _readings(jobs, device, seed, least=0):
    blocks = [[judge.block_rows(r, "Consensus_")[0]
               for r in seqs.read_maf(j["out_maf"])] for j in jobs]
    rng = np.random.default_rng(seed)
    picks = judge.sample_pairs(blocks, rng, least)
    prog = judge.poa_gaps(blocks, picks, device)
    ctrl = judge.control_gaps(blocks, picks, device)
    return prog, ctrl


def test_control_fails_where_the_program_passes(tmp_path):
    from smoothxg_tpu_torch.cli import main
    from port_bench.synth import make_pangenome
    d = str(tmp_path)
    gfa = os.path.join(d, "in.gfa")
    with open(gfa, "w") as f:
        f.write(make_pangenome(haplotypes=4, length=6000, indel_rate=0.002,
                               sv_count=1, seed=12))
    out, maf = os.path.join(d, "out.gfa"), os.path.join(d, "out.maf")
    assert main(["-g", gfa, "-o", out, "-m", maf, "-r", "4", "-j", "5k",
                 "-e", "5k", "-l", "4000", "-t", "1", "--engine",
                 "native", "-b", d]) == 0
    prog, ctrl = _readings([{"out_maf": maf}], "cpu", 3)
    limit = spec.cell("l4000.hap90")["config"]["limits"]["poa_gap_max"]
    assert max(prog) <= limit < max(ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["l4000.hap90", "l4000-band0.hap90"])
@pytest.mark.parametrize("seed", [2147483659, 3000000019, 4000000037])
def test_card_control_at_the_cells_size(tmp_path, cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from port_bench.cell import job_argv, make_engine, run_job, settings
    from port_bench.traffic import make_graphs
    c = spec.cell(cell)
    graphs = make_graphs(c["traffic"], seed, str(tmp_path))
    eng = make_engine(settings(c["config"], c["traffic"]), "cuda")
    out = str(tmp_path / "job")
    os.makedirs(out)
    t = time.perf_counter()
    run_job(eng, "cuda", job_argv(c["config"], c["traffic"],
                                  graphs[0]["gfa"], out))
    t_job = time.perf_counter() - t
    del eng
    torch.cuda.empty_cache()
    t = time.perf_counter()
    prog, ctrl = _readings([{"out_maf": os.path.join(out, "out.maf")}],
                           "cuda", seed)
    print(json.dumps({"cell": cell, "seed": seed, "graph": graphs[0]["seed"],
                      "job_s": t_job, "read_s": time.perf_counter() - t,
                      "program": prog, "control": ctrl}))
    limit = c["config"]["limits"]["poa_gap_max"]
    assert max(prog) <= limit < max(ctrl)
