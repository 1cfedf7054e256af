"""Spans of the port's layers, kept in memory for a traced run.

A span is a name, its start and end on the program's clock
(`time.perf_counter_ns`), the span open around it on the same thread (its
parent; 0 for none), the job it belongs to and an optional small value
(`attrs`: a block id, or a dict of a few).  `run_smoothing` opens each
job's root span, `job`, under a job id of its own, which every span of the
job shares.  Records stay in memory until `take()` returns and clears them.

Off by default.  Off, `span()` is one check of a module flag that returns
a shared no-op context manager: no allocation, no clock read.  `enable()`
and `disable()` switch it for the process.  A job also records its spans
while torch's profiler records in this process (`profiler_recording`), so
that a profiled run has the program's spans to set beside the profiler's
events.  Pool workers (`-t N`) never enable it and record nothing.

Standard library only: the host stages import this module, and torch stays
out of them and out of their pool workers."""
from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import NamedTuple


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    job: int
    attrs: object = None


_on = False
_job = 0
_records: list[Record] = []
_ids = itertools.count(1)
_jobs = itertools.count(1)
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    """The ids of the spans open on this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0")

    def __init__(self, name: str, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        _records.append(Record(self.name, self.t0, t1, self.id, self.parent,
                               _job, self.attrs))
        return False


def span(name: str, attrs=None):
    """A context manager that records `name` around its body while spans
    are on; the shared no-op one while they are off."""
    if not _on:
        return _NOOP
    return _Span(name, attrs)


class _Job:
    __slots__ = ("was", "prev", "root")

    def __enter__(self):
        global _on, _job
        self.was = _on
        _on = _on or profiler_recording()
        self.root = None
        if _on:
            self.prev = _job
            _job = next(_jobs)
            self.root = _Span("job", None).__enter__()
        return None

    def __exit__(self, *exc):
        global _on, _job
        if self.root is not None:
            self.root.__exit__(*exc)
            _job = self.prev
        _on = self.was
        return False


def job() -> _Job:
    """The root span of one job, `job`, under a new job id; spans are on
    inside it when they are on, or while torch's profiler records."""
    return _Job()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> list[Record]:
    """The records so far, in the order their spans ended; clears them."""
    global _records
    out, _records = _records, []
    return out


def profiler_recording() -> bool:
    """Whether torch's profiler records in this process.  Reads the flag
    torch keeps and imports nothing: without torch loaded it is False."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(getattr(prof, "_is_profiler_enabled", False))
