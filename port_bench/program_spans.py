"""The program's own spans (`smoothxg_tpu_torch/utils/spans.py`) in a
traced run, on the profiler's clock.

A job run while torch's profiler records keeps its spans in memory.  The
first reader that asks takes them (`spans.take()`), maps them onto the
trace's timeline (seconds from the window's start, as `trace.Tracer.reduce`
gives the device's operations) and keeps them in the run's context for
the other readers.  A program without spans (one older than them) gives
every reader None.

The clocks meet at anchor pairs: two readings of one instant, one on each
clock.  Each pipeline stage gives two: the program opens a span inside
every `phase`, and the traced run wraps every `phase` in a
`record_function` of the same name (`trace.Tracer.install`), so a stage
starts and ends on both clocks back to back.  The offset comes from the
first stage's start, the scale from it and the last stage's start; the
largest distance of any pair, ends included, from that line is logged,
with each span name's total."""
from __future__ import annotations

import sys

from . import trace

KEY = "program_spans"


def fit(anchors) -> tuple[float, float]:
    """(offset, scale) of the line t_profiler = offset + scale x
    t_program through the first and the last of `anchors`, pairs of
    (t_program, t_profiler), first and last on the program's clock."""
    pts = sorted(anchors)
    (p0, q0), (p1, q1) = pts[0], pts[-1]
    scale = (q1 - q0) / (p1 - p0) if p1 > p0 else 1.0
    return q0 - scale * p0, scale


def stage_anchors(records, stages) -> list:
    """Anchor pairs from the stages both clocks saw: [(t_program,
    t_profiler)] at the start and at the end of each, in seconds, starts
    at even indices.  The k-th program span of a name pairs with the k-th
    traced stage of that name, each in order of its start."""
    traced: dict = {}
    for name, s, e in sorted(stages, key=lambda x: x[1]):
        traced.setdefault(name, []).append((s, e))
    seen: dict = {}
    pairs = []
    for r in sorted(records, key=lambda r: r.start_ns):
        k = seen.get(r.name, 0)
        if k >= len(traced.get(r.name, ())):
            continue
        seen[r.name] = k + 1
        s, e = traced[r.name][k]
        pairs += [(r.start_ns * 1e-9, s), (r.end_ns * 1e-9, e)]
    return pairs


def mapped(ctx: dict):
    """The run's program spans on the trace's timeline: [(name, start,
    end, id, parent, job)], seconds from the window's start; None where
    the program records none."""
    if KEY not in ctx:
        ctx[KEY] = _take_and_map(ctx)
    return ctx[KEY]


def _take_and_map(ctx: dict):
    try:
        from smoothxg_tpu_torch.utils import spans
    except ImportError:
        return None
    records = spans.take()
    anchors = stage_anchors(records, ctx["trace"]["spans"])
    if not anchors:
        return None
    # the line through the stages' starts: a stage's end on the
    # profiler's clock comes ~0.1 ms after the program's, past the
    # phase's last log line
    off, scale = fit(anchors[0::2])
    out = [(r.name, off + scale * r.start_ns * 1e-9,
            off + scale * r.end_ns * 1e-9, r.id, r.parent, r.job)
           for r in records]
    gap = max(abs(off + scale * p - q) for p, q in anchors)
    _log(f"span clock: {len(anchors) // 2} stages anchored, scale "
         f"{scale:.9f}, farthest anchor {gap * 1e3:.4f} ms")
    totals: dict = {}
    for name, s, e, *_ in out:
        t = totals.setdefault(name, [0.0, 0])
        t[0] += e - s
        t[1] += 1
    for name, (sec, n) in sorted(totals.items(), key=lambda x: -x[1][0]):
        _log(f"span {name} {sec:.6f} s, {n} spans")
    return out


def _log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def s_per_Mbp(ctx: dict, name: str):
    """The seconds of the window's spans named `name`, summed, per Mbp of
    input path."""
    sp = mapped(ctx)
    if not sp or not ctx["mbp"]:
        return None
    return sum(e - s for n, s, e, *_ in sp if n == name) / ctx["mbp"]


def overlap_s(a, b) -> float:
    """Seconds that two merged interval lists (`trace.union`) share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def engine_idle_share(ctx: dict):
    """The share of the union of the engine's spans in which no operation
    ran on the device, in %."""
    sp = mapped(ctx)
    if not sp:
        return None
    eng = trace.union((s, e) for n, s, e, *_ in sp if n.startswith("engine."))
    total = sum(e - s for s, e in eng)
    if total <= 0:
        return None
    dev = trace.union((s, e) for _, s, e in ctx["trace"]["device"])
    return 100.0 * (1.0 - overlap_s(eng, dev) / total)
