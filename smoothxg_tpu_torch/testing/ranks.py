"""Run the port's CLI as the ranks of one multi-process run: one process
per rank on this host, the process group's coordinator on a free local
port.  A rank that fails ends the others (they would wait for it in the
all-gather), so the call returns instead of hanging."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv: list, size: int, per_rank=None, timeout: float = 600.0,
              env: dict | None = None) -> list:
    """Start `python -m smoothxg_tpu_torch.cli *argv` once per rank with
    --dist-rank r --dist-size size and a common coordinator; `per_rank(r)`
    gives extra arguments of rank r (say its own -b temp dir).  Returns
    [(exit code, stderr)] by rank; past `timeout` seconds, or once a rank
    has failed, the ranks still running are killed (exit code None, as
    for any rank ended by a signal)."""
    coord = f"localhost:{free_port()}"
    procs = []
    for r in range(size):
        cmd = [sys.executable, "-m", "smoothxg_tpu_torch.cli", *argv,
               *(per_rank(r) if per_rank else []), "--dist-rank", str(r),
               "--dist-size", str(size), "--dist-coordinator", coord]
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    # stderr is drained by threads so a chatty rank cannot block on a pipe
    errs = [""] * size

    def drain(k):
        errs[k] = procs[k].stderr.read()

    threads = [threading.Thread(target=drain, args=(k,), daemon=True)
               for k in range(size)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    codes = [p.wait() for p in procs]
    for t in threads:
        t.join(timeout=30)
    return [(c if c >= 0 else None, e) for c, e in zip(codes, errs)]
