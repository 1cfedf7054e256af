"""The port's spans (smoothxg_tpu_torch/utils/spans.py) on tiny CPU runs of
run_smoothing: a root `job` a call, every span under it and sharing its
job id, no engine span around the consumer's rehydrate, nothing recorded
with spans off or from `-t N` pool workers, totals equal to the smoothing
line's figures, and a program span mapped onto torch.profiler's clock
through anchor pairs, and spans recorded unasked while torch's profiler
records."""
import contextlib
import io
import re
import time

import pytest

from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import write_pangenome
from smoothxg_tpu_torch.utils import spans
from smoothxg_tpu_torch.utils.progress import stage_name

SMOOTH_RE = re.compile(r"(\d+) blocks: engine ([\d.]+)s, rehydrate "
                       r"([\d.]+)s, finalize ([\d.]+)s")


def _config(tmp, gfa, engine, threads=1) -> Config:
    # no padding, so the blocks fit the plain version's small tier
    return Config(gfa_in=gfa, smoothed_out=str(tmp / "out.gfa"), n_haps=4,
                  poa_length_targets=[200], poa_padding_fraction=0.0,
                  write_msa_in_maf_format=str(tmp / "out.maf"),
                  add_consensus=True, engine=engine, threads=threads)


def _cpu_engine():
    """The card's engine on the CPU (poa_win's plain version)."""
    return TorchPOAEngine(device="cpu", threads=1, tiers=((1024, 512, 512),))


def _run(tmp, gfa, engine, threads=1) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run_smoothing(_config(tmp, gfa, engine, threads), device="cpu",
                      engine=engine)
    return err.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two calls with spans on (the card's engine on the CPU, then the
    native engine) and the first again with them off."""
    tmp = tmp_path_factory.mktemp("spans")
    gfa = write_pangenome(str(tmp / "in.gfa"), haplotypes=4, length=3000,
                          seed=3)
    spans.take()
    spans.enable()
    try:
        log = _run(tmp, gfa, _cpu_engine())
        first = spans.take()
        _run(tmp, gfa, NativePOAEngine(threads=1))
        second = spans.take()
    finally:
        spans.disable()
    _run(tmp, gfa, _cpu_engine())
    off = spans.take()
    return {"log": log, "first": first, "second": second, "off": off,
            "gfa": gfa, "tmp": tmp}


def _total(records, pred) -> float:
    return sum(r.end_ns - r.start_ns for r in records if pred(r.name)) * 1e-9


def test_one_job_root_per_call(runs):
    first, second = runs["first"], runs["second"]
    jobs = set()
    for recs in (first, second):
        roots = [r for r in recs if r.name == "job"]
        assert len(roots) == 1 and roots[0].parent == 0
        root = roots[0]
        assert {r.job for r in recs} == {root.job}
        ids = {r.id: r for r in recs}
        for r in recs:
            # every span reaches the root through open spans around it
            while r.parent:
                p = ids[r.parent]
                assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
                r = p
            assert r is root
        jobs.add(root.job)
    assert len(jobs) == 2
    names = {r.name for r in first}
    assert {"prepping graph", "smoothing N blocks", "smooth.extract",
            "smooth.rehydrate", "smooth.finalize", "finalize.consensus",
            "finalize.maf", "finalize.build", "finalize.unchop",
            "engine.launch", "engine.wait", "engine.copy"} <= names


def test_no_engine_span_encloses_rehydrate(runs):
    recs = runs["first"]
    reh = [r for r in recs if r.name == "smooth.rehydrate"]
    eng = [r for r in recs if r.name.startswith("engine.")]
    assert reh and eng
    for r in reh:
        for e in eng:
            assert not (e.start_ns <= r.start_ns and r.end_ns <= e.end_ns)
        assert r.parent not in {e.id for e in eng}


def test_spans_off_record_nothing(runs):
    assert runs["off"] == []
    assert spans.span("a") is spans.span("b")


def test_span_totals_match_the_smoothing_line(runs):
    """Within 2%, and the line's own rounding to 10 ms."""
    m = SMOOTH_RE.search(runs["log"])
    engine, rehydrate, finalize = (float(m.group(k)) for k in (2, 3, 4))
    recs = runs["first"]
    for line, spanned in (
            (engine, _total(recs, lambda n: n.startswith("engine."))),
            (rehydrate, _total(recs, lambda n: n == "smooth.rehydrate")),
            (finalize, _total(recs, lambda n: n == "smooth.finalize"))):
        assert abs(spanned - line) <= 0.02 * line + 0.005, (spanned, line)
    assert engine > 0.1
    parts = _total(recs, lambda n: n.startswith("finalize."))
    assert 0.9 * _total(recs, lambda n: n == "smooth.finalize") <= parts


def test_pool_workers_record_nothing(runs, tmp_path):
    """At -t 2 the blocks' bodies run in the pool's workers: the main
    process records its own spans, the workers none, and nothing fails."""
    spans.take()
    spans.enable()
    try:
        _run(tmp_path, runs["gfa"], NativePOAEngine(threads=2), threads=2)
        recs = spans.take()
    finally:
        spans.disable()
    names = {r.name for r in recs}
    assert "job" in names and "smoothing N blocks" in names
    assert "smooth.finalize" not in names


@pytest.mark.parametrize("msg,name", [
    ("loading graph /tmp/x/in.gfa", "loading graph"),
    ("smoothing 22 blocks", "smoothing N blocks"),
    ("prepping graph", "prepping graph"),
    ("merging / grooming blocks", "merging grooming blocks"),
    ("writing MAF /a/out.maf", "writing MAF"),
    ("loading index x.idx", "loading index x.idx")])
def test_stage_names_are_the_harness_labels(msg, name):
    """The benchmark labels a stage by the same rule; the parity with its
    own copy is tested beside the benchmark."""
    assert stage_name(msg) == name


def test_a_job_under_the_profiler_records_unasked(runs, tmp_path):
    """With spans off, a job run while torch's profiler records keeps its
    spans (the traced benchmark run's route), and one run outside it
    keeps none: `profiler_recording` follows torch's own flag."""
    from torch.profiler import ProfilerActivity, profile

    spans.take()
    assert not spans.profiler_recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.profiler_recording()
        _run(tmp_path, runs["gfa"], NativePOAEngine(threads=1))
    assert not spans.profiler_recording()
    recs = spans.take()
    roots = [r for r in recs if r.name == "job"]
    assert len(roots) == 1 and roots[0].parent == 0
    assert {r.job for r in recs} == {roots[0].job}
    names = {r.name for r in recs}
    assert {"prepping graph", "smoothing N blocks", "smooth.finalize",
            "finalize.unchop"} <= names
    _run(tmp_path, runs["gfa"], NativePOAEngine(threads=1))
    assert spans.take() == []


def test_program_span_maps_onto_the_profiler_clock():
    """A span inside a record_function around a 50 ms sleep lands on it,
    within 1 ms at both ends, through two anchor pairs (a record_function
    mark and a program-clock reading, back to back)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def anchor(name):
        t = time.perf_counter_ns()
        with record_function(name):
            pass
        return t * 1e-9

    spans.take()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            a0 = anchor("anchor.0")
            time.sleep(0.02)
            with record_function("sleep"):
                with spans.span("sleep"):
                    time.sleep(0.05)
            time.sleep(0.02)
            a1 = anchor("anchor.1")
        rec, = spans.take()
    finally:
        spans.disable()
    ev = {e.name: (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
          for e in prof.events()}
    # the line through the two anchor pairs: offset and scale
    scale = (ev["anchor.1"][0] - ev["anchor.0"][0]) / (a1 - a0)
    off = ev["anchor.0"][0] - scale * a0
    s = off + scale * rec.start_ns * 1e-9
    e = off + scale * rec.end_ns * 1e-9
    assert abs(s - ev["sleep"][0]) < 1e-3
    assert abs(e - ev["sleep"][1]) < 1e-3
    # the span holds the sleep on the program's own clock; mapped, its
    # length moves by the scale's error (the anchors' jitter over ~90 ms)
    assert (rec.end_ns - rec.start_ns) * 1e-9 >= 0.05
