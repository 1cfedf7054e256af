"""The traced run's instruments: spans around the pipeline's phases, the
smoothing phase's own figures, and the device's operations from
`torch.profiler` (CUPTI), all on the profiler's clock.

Nothing here runs in an untraced run.  The spans come from wrapping the
program's `phase` context manager (`pipeline/run.py` calls it around each
stage) and the figures from its `[smoothxg_tpu::smooth] N blocks: engine
.., rehydrate .., finalize ..` line (`pipeline/smooth.py`)."""
from __future__ import annotations

import re
import time
from contextlib import contextmanager

SMOOTH_RE = re.compile(r"(\d+) blocks: engine ([\d.]+)s, rehydrate "
                       r"([\d.]+)s, finalize ([\d.]+)s")
WINDOW = "port_bench.window"
PHASE = "phase: "


def _label(msg: str) -> str:
    """A phase's message without its paths and counts."""
    words = [w for w in msg.split() if "/" not in w]
    return " ".join("N" if w.isdigit() else w for w in words)


class Tracer:
    def __init__(self):
        self.smooth: list[dict] = []
        self.prof = None
        self._undo = []

    def install(self):
        """Wrap the program's phase spans and smoothing figures."""
        from torch.profiler import record_function

        from smoothxg_tpu_torch.pipeline import run as prun
        from smoothxg_tpu_torch.utils.progress import Log

        orig_phase, orig_info = prun.phase, Log.info

        @contextmanager
        def phase(tag, msg):
            with record_function(PHASE + _label(msg)):
                with orig_phase(tag, msg):
                    yield

        def info(tag, msg):
            m = SMOOTH_RE.search(msg)
            if m:
                self.smooth.append(dict(
                    blocks=int(m.group(1)), engine=float(m.group(2)),
                    rehydrate=float(m.group(3)),
                    finalize=float(m.group(4))))
            orig_info(tag, msg)

        prun.phase = phase
        Log.info = staticmethod(info)
        self._undo = [(prun, "phase", orig_phase),
                      (Log, "info", staticmethod(orig_info))]

    def uninstall(self):
        for obj, name, val in self._undo:
            setattr(obj, name, val)

    @contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            with record_function(WINDOW):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def reduce(self) -> dict:
        """{"window_s", "device": [(name, start, end)], "spans": [(label,
        start, end)]}, seconds from the window's start."""
        t = time.perf_counter()
        evs = _events(self.prof)
        win = [(s, e) for dev, name, s, e in evs
               if not dev and name == WINDOW]
        if not win:
            raise RuntimeError("the profiler lost the window's span")
        w0, w1 = win[0]
        # the spans' own images on the device's timeline are no operation
        device = sorted(((name, max(s, w0) - w0, min(e, w1) - w0)
                         for dev, name, s, e in evs
                         if dev and e > w0 and s < w1
                         and not name.startswith((PHASE, WINDOW))),
                        key=lambda x: x[1])
        spans = [(name[len(PHASE):], s - w0, e - w0)
                 for dev, name, s, e in evs
                 if not dev and name.startswith(PHASE)]
        return {"window_s": w1 - w0, "device": device, "spans": spans,
                "reduce_s": time.perf_counter() - t}


def _events(prof) -> list:
    """(on the device, name, start s, end s) of every profiled event."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        tr = ev.time_range
        out.append((ev.device_type == DeviceType.CUDA, ev.name,
                    tr.start * 1e-6, tr.end * 1e-6))
    return out


def union(intervals) -> list:
    """Merged (start, end) of intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_s(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps, each named by the phases the host was in during
    it, the longest first, with their seconds inside the gap."""
    by: dict = {}
    for name, s, e in tr["device"]:
        by[name] = by.get(name, 0.0) + (e - s)
    ops = sorted(by.items(), key=lambda x: -x[1])[:top]
    busy = union((s, e) for _, s, e in tr["device"])
    gaps, prev = [], 0.0
    for s, e in busy + [[tr["window_s"], tr["window_s"]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        inside: dict = {}
        for label, s, e in tr["spans"]:
            if min(b, e) > max(a, s):
                inside[label] = inside.get(label, 0.0) + min(b, e) - max(a, s)
        rest = (b - a) - sum(inside.values())
        if rest > 1e-3:
            inside["outside the pipeline's phases"] = rest
        parts = sorted(inside.items(), key=lambda x: -x[1])[:3]
        named.append([" + ".join(f"{k} {v:.3f} s" for k, v in parts),
                      b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
