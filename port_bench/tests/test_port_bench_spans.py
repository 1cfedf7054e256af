"""The readers of the program's spans on a synthetic traced run: records
on the program's clock, the harness's stage spans and the device's
operations on the profiler's, mapped through the stages' anchors."""
import sys

import pytest

from port_bench import program_spans, spec
from smoothxg_tpu_torch.utils import spans
from smoothxg_tpu_torch.utils.spans import Record

OFF = 100.0          # the program's clock runs 100 s ahead of the trace's


def _rec(name, s, e, id_, parent):
    return Record(name, int(round((s + OFF) * 1e9)),
                  int(round((e + OFF) * 1e9)), id_, parent, 1)


RECORDS = [
    _rec("prepping graph", 0.5, 1.0, 2, 1),
    _rec("smooth.extract", 1.0, 1.2, 4, 3),
    _rec("engine.launch", 1.2, 1.5, 5, 3),
    _rec("engine.wait", 1.5, 2.5, 6, 3),
    _rec("engine.copy", 2.5, 2.7, 7, 3),
    _rec("smooth.rehydrate", 2.7, 3.0, 8, 3),
    _rec("engine.host", 3.0, 3.1, 9, 3),
    _rec("finalize.consensus", 3.1, 3.3, 11, 10),
    _rec("finalize.maf", 3.3, 3.8, 12, 10),
    _rec("finalize.build", 3.8, 4.4, 13, 10),
    _rec("finalize.unchop", 4.4, 4.9, 14, 10),
    _rec("smooth.finalize", 3.1, 5.0, 10, 3),
    _rec("smoothing N blocks", 1.0, 5.0, 3, 1),
    _rec("prepping graph", 5.5, 6.5, 15, 1),
    _rec("job", 0.5, 6.5, 1, 0),
]
TRACE = {"window_s": 7.0,
         # a gap inside engine.wait (1.9-2.1) and one across the copy
         "device": [("k", 1.3, 1.9), ("k", 2.1, 2.5), ("m", 2.6, 2.8)],
         "spans": [("prepping graph", 0.5, 1.0),
                   ("smoothing N blocks", 1.0, 5.0),
                   ("prepping graph", 5.5, 6.5)]}
MBP = 2.0
EXPECT = {
    "stage.prep.s_per_Mbp": 1.5 / MBP,
    "smooth.extract.s_per_Mbp": 0.2 / MBP,
    "smooth.finalize.consensus.s_per_Mbp": 0.2 / MBP,
    "smooth.finalize.maf.s_per_Mbp": 0.5 / MBP,
    "smooth.finalize.build.s_per_Mbp": 0.6 / MBP,
    "smooth.finalize.unchop.s_per_Mbp": 0.5 / MBP,
    "engine.launch.s_per_Mbp": 0.3 / MBP,
    "engine.wait.s_per_Mbp": 1.0 / MBP,
    "engine.copy.s_per_Mbp": 0.2 / MBP,
    # engine spans 1.2-2.7 and 3.0-3.1 (1.6 s); the card ran in 1.3-1.9,
    # 2.1-2.5 and 2.6-2.7 of them (1.1 s)
    "engine.device_idle_share": 100.0 * 0.5 / 1.6,
}


def _ctx():
    return {"trace": TRACE, "mbp": MBP, "window_s": TRACE["window_s"]}


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "take", lambda: list(RECORDS))


@pytest.mark.parametrize("metric", sorted(EXPECT))
def test_reader(recorded, metric):
    assert spec.reader(metric)(_ctx()) == pytest.approx(EXPECT[metric],
                                                        abs=1e-9)


def test_every_new_reader_is_in_the_benchmark():
    names = {m["name"] for m in spec.benchmark()["per_layer"]}
    assert set(EXPECT) <= names


def test_spans_map_through_the_stage_anchors(recorded):
    ctx = _ctx()
    sp = program_spans.mapped(ctx)
    assert [(n, round(s, 9), round(e, 9)) for n, s, e, *_ in sp] == \
        [(r.name, round(r.start_ns * 1e-9 - OFF, 9),
          round(r.end_ns * 1e-9 - OFF, 9)) for r in RECORDS]
    assert program_spans.mapped(ctx) is sp      # taken once a run


def test_fit_takes_offset_and_scale():
    off, scale = program_spans.fit([(10.0, 1.0), (30.0, 21.002),
                                    (20.0, 11.0)])
    assert scale == pytest.approx(1.0001)
    assert off + scale * 10.0 == pytest.approx(1.0)


def test_a_program_without_spans_gives_none(monkeypatch):
    import smoothxg_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "smoothxg_tpu_torch.utils.spans", None)
    for metric in EXPECT:
        assert spec.reader(metric)(_ctx()) is None


def test_no_stage_anchor_gives_none(monkeypatch):
    monkeypatch.setattr(spans, "take", lambda: [RECORDS[1]])
    assert spec.reader("smooth.extract.s_per_Mbp")(_ctx()) is None


def test_copy_bytes_reader():
    """The engine's `copy_bytes` over the window, per Mbp; None on an
    engine without the counter (one older than it)."""
    read = spec.reader("engine.copy_MB_per_Mbp")
    ctx = {"mbp": MBP, "stats0": {"copy_bytes": 1_000_000},
           "stats1": {"copy_bytes": 9_000_000}}
    assert read(ctx) == pytest.approx(8.0 / MBP)
    assert read({"mbp": MBP, "stats0": {"redo": 0},
                 "stats1": {"redo": 1}}) is None
    assert read({"mbp": MBP, "stats0": {}, "stats1": {}}) is None
    names = {m["name"] for m in spec.benchmark()["per_layer"]}
    assert "engine.copy_MB_per_Mbp" in names


@pytest.mark.parametrize("msg", [
    "loading graph /tmp/x/in.gfa", "smoothing 22 blocks", "prepping graph",
    "merging / grooming blocks", "writing MAF /a/out.maf",
    "loading index x.idx"])
def test_stage_names_are_the_harness_labels(msg):
    """The program names a stage's span as the harness labels its
    `record_function`, so the two pair up as anchors."""
    from port_bench import trace
    from smoothxg_tpu_torch.utils.progress import stage_name
    assert stage_name(msg) == trace._label(msg)
