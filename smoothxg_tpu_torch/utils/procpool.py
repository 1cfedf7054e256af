"""Host-stage process parallelism.

The reference parallelizes its host stages with OpenMP (block smoothing
src/smooth.cpp:1904, WFA clustering src/breaks.cpp:198, lace walks
src/main.cpp:622-772); the equivalents here are pure-Python/numpy loops, so
`-t/-T` map to a process pool.  Spawn context (never fork): the parent
holds a CUDA context (the engine, its background warm-up) and threads (the
warm-up, the engine's rate watchers), and a child forked after CUDA is
initialised cannot use CUDA and may deadlock on a lock some thread held.
A spawned worker starts a fresh interpreter with the parent's environment
and imports its tasks' modules; the host stages import no torch at module
level, so a worker never loads it.
"""
from __future__ import annotations

import atexit
import os
import time
from concurrent.futures import ProcessPoolExecutor

_POOL: ProcessPoolExecutor | None = None
_POOL_SIZE = 0


def _init_worker() -> None:
    # Detach from the parent's stdio so an inherited pipe can never be
    # held open past the parent's exit even if this worker is wedged.
    # Worker exceptions travel back through the futures channel, not
    # stderr, so nothing user-visible is lost.
    if os.environ.get("SMXG_WORKER_STDIO") != "1":
        try:
            devnull = os.open(os.devnull, os.O_RDWR)
            for fd in (0, 1, 2):
                os.dup2(devnull, fd)
            os.close(devnull)
        except Exception:
            pass


def get_pool(n_workers: int) -> ProcessPoolExecutor:
    """Lazily created, process-wide pool; resized when n changes.

    All workers are spawned eagerly, here: 3.12's ProcessPoolExecutor
    starts a spawn-context worker synchronously inside submit() while it
    has fewer than max_workers, so every worker's interpreter start and
    imports begin now, while the caller goes on with its own work (`warm`),
    and not one at a time as the first parallel stage submits its tasks.
    """
    global _POOL, _POOL_SIZE
    if _POOL is not None and _POOL_SIZE != n_workers:
        shutdown()
    if _POOL is None:
        import multiprocessing as mp
        _POOL = ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_init_worker)
        # eager spawn: each submit() starts one worker synchronously
        for _ in range(n_workers):
            _POOL.submit(_noop)
        deadline = time.monotonic() + 10.0
        while (len(getattr(_POOL, "_processes", {})) < n_workers
               and time.monotonic() < deadline):
            _POOL.submit(_noop)
            time.sleep(0.01)
        _POOL_SIZE = n_workers
        atexit.register(shutdown)
    return _POOL


def _noop() -> None:
    pass


def shutdown() -> None:
    """Terminate pool workers NOW, escalating to SIGKILL.  Registered
    with atexit, which the port's CLI (smoothxg_tpu_torch.cli) reaches
    when it returns; a caller that ends the pool early (a resize, a run
    that must not share workers with the next) or hard-exits through
    os._exit, which skips atexit, calls it itself: orphaned spawn workers
    would otherwise outlive the caller, holding its inherited stdio pipes
    open until their queued tasks end (a parent reading those pipes then
    blocks).  terminate() sends SIGTERM, which code loaded in a worker may
    catch or ignore, so any survivor gets SIGKILL, which cannot be.
    """
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        procs = list(getattr(_POOL, "_processes", {}).values())
        try:
            _POOL.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        for p in procs:
            try:
                p.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + 2.0
        for p in procs:
            try:
                p.join(max(0.0, deadline - time.monotonic()))
            except Exception:
                pass
        for p in procs:
            try:
                if p.is_alive():
                    p.kill()
                    p.join(1.0)
            except Exception:
                pass
        # bounded wait for the manager thread so it can unlink the call
        # queue's semaphores (otherwise an os._exit caller trips a noisy
        # resource_tracker "leaked semaphore" warning on every piped run)
        try:
            t = getattr(_POOL, "_executor_manager_thread", None)
            if t is not None and t.is_alive():
                t.join(2.0)
        except Exception:
            pass
        try:
            q = getattr(_POOL, "_call_queue", None)
            if q is not None:
                q.close()
                q.join_thread()
        except Exception:
            pass
        _POOL = None
        _POOL_SIZE = 0
        import gc
        gc.collect()  # drop queue finalizers now so their semaphores are
        # unlinked before an os._exit caller skips interpreter teardown


def _warm_task() -> None:
    # front-load the imports a real task would pay at unpickle time
    from ..pipeline import breaks, smooth  # noqa: F401


def warm(n_workers: int) -> None:
    """Fire-and-forget worker boot.  Spawned workers cost ~0.5 s of
    interpreter + import startup; kicking them off at pipeline start
    overlaps that with graph load/prep instead of landing it on the first
    parallel stage's critical path."""
    if n_workers and n_workers > 1:
        pool = get_pool(n_workers)
        for _ in range(n_workers):
            pool.submit(_warm_task)


def chunked(items: list, n_chunks: int) -> list[list]:
    """Split into at most n_chunks contiguous, near-equal chunks."""
    n_chunks = max(1, min(n_chunks, len(items)))
    q, r = divmod(len(items), n_chunks)
    out, pos = [], 0
    for i in range(n_chunks):
        size = q + (1 if i < r else 0)
        out.append(items[pos:pos + size])
        pos += size
    return out
