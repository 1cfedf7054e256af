"""Phase banners + progress logging to stderr.

Equivalent to the reference's ProgressMeter (reference: src/progress.hpp:12-84):
phase start/end banners with elapsed time, plus an optional sampling-thread
meter printing %/rate/ETA for block-loop phases that complete work
incrementally (smoothing chunks, break/split).  Each phase is also a span
(utils/spans.py), named by `stage_name`.
"""
from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager

from .spans import span


class Log:
    enabled = True

    @staticmethod
    def info(tag: str, msg: str) -> None:
        if Log.enabled:
            print(f"[smoothxg_tpu::{tag}] {msg}", file=sys.stderr, flush=True)

    @staticmethod
    def notice(tag: str, msg: str) -> None:
        """Loud one-line notice, printed even when info logging is off —
        for behavior divergences a user must not miss (e.g. the
        --long-poa-band semantic switch)."""
        print(f"[smoothxg_tpu::{tag}] NOTICE: {msg}", file=sys.stderr,
              flush=True)


def stage_name(msg: str) -> str:
    """A phase's span name: its message without paths and with each count
    as N ("smoothing 22 blocks" -> "smoothing N blocks")."""
    words = [w for w in msg.split() if "/" not in w]
    return " ".join("N" if w.isdigit() else w for w in words)


@contextmanager
def phase(tag: str, msg: str):
    with span(stage_name(msg)):
        t0 = time.time()
        Log.info(tag, msg)
        yield
        Log.info(tag, f"{msg} done in {time.time() - t0:.2f}s")


class ProgressMeter:
    """Counter + logger thread printing %/rate/ETA every ``interval`` s.

    Mirrors the reference's ProgressMeter (src/progress.hpp:12-84): the
    work loop calls increment(); a daemon thread samples the counter and
    reports progress.  No line is printed for phases that finish inside
    the first interval, so short runs (tests, small graphs) stay quiet.
    """

    def __init__(self, total: int, tag: str, msg: str,
                 interval: float = 2.0):
        self.total = max(int(total), 1)
        self.tag = tag
        self.msg = msg
        self.count = 0
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if Log.enabled and interval > 0:
            self._thread = threading.Thread(
                target=self._run, args=(interval,), daemon=True)
            self._thread.start()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def _line(self) -> str:
        done = self.count
        dt = max(time.time() - self._t0, 1e-9)
        rate = done / dt
        eta = (self.total - done) / rate if rate > 0 else float("inf")
        pct = 100.0 * done / self.total
        eta_s = f"{eta:.0f}s" if eta < 1e5 else "?"
        return (f"{self.msg} {pct:5.1f}% {done}/{self.total} "
                f"@ {rate:.2f}/s ETA {eta_s}")

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            if self.count >= self.total:
                return
            Log.info(self.tag, self._line())

    def finish(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
