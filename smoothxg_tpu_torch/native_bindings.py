"""ctypes bindings for the native graphcore library (csrc/host/graphcore.cpp).

The native layer implements the host runtime's hottest graph transform —
unchop + toposort + renumber over flat arrays — in C++ (the reference uses
odgi's C++ for the same ops; see csrc/host/graphcore.cpp).  The library is
built with g++ at first use (ops/_build.host_lib).  Falls back to the
pure-Python implementation when it does not build.
"""
from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
_TRIED = False


def load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    from .ops._build import host_lib
    path = host_lib("graphcore")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.gc_unchop.restype = ctypes.c_void_p
    lib.gc_unchop.argtypes = [i64, pu8, p64, i64, p64, i64, p64, p64,
                              ctypes.c_int, ctypes.c_int]
    lib.gc_block_unchop.restype = ctypes.c_void_p
    lib.gc_block_unchop.argtypes = [i64, pu8, i64, p64, p64, i64, i64, p64,
                                    pu8, ctypes.c_int, i64, p64,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for f in ("gc_n_nodes", "gc_seq_len", "gc_n_edges", "gc_n_steps"):
        getattr(lib, f).restype = i64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.gc_copy.restype = None
    lib.gc_copy.argtypes = [ctypes.c_void_p, pu8, p64, p64, p64, p64, i64]
    lib.gc_free.restype = None
    lib.gc_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "bf_sweep"):
        lib.bf_sweep.restype = ctypes.c_void_p
        lib.bf_sweep.argtypes = [i64, i64, p64, p64, p64, p64, p64, p64,
                                 p64, p64, i64, i64, i64, i64,
                                 ctypes.c_int32]
        for f in ("bf_n_blocks", "bf_n_ranges"):
            getattr(lib, f).restype = i64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.bf_copy.restype = None
        lib.bf_copy.argtypes = [ctypes.c_void_p, p64, p64, p64, p64, p64]
        lib.bf_free.restype = None
        lib.bf_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def bf_sweep(n_nodes: int, n_paths: int, node_len, node_steps_start,
             step_path, step_rank, path_off, path_pos_flat,
             path_steps_flat, ejump, max_block_weight,
             max_block_path_length, max_path_jump, max_edge_jump,
             order_longest: bool):
    """Native block-finder sweep (graphcore.cpp bf_sweep — the exact
    semantics of pipeline/blocks.smoothable_blocks).  Returns
    (block_off, pid, begin, end, length) arrays or None when the library
    lacks the entry point."""
    lib = load()
    if lib is None or not hasattr(lib, "bf_sweep"):
        return None
    a = np.ascontiguousarray
    r = lib.bf_sweep(
        n_nodes, n_paths, a(node_len, dtype=np.int64),
        a(node_steps_start, dtype=np.int64), a(step_path, dtype=np.int64),
        a(step_rank, dtype=np.int64), a(path_off, dtype=np.int64),
        a(path_pos_flat, dtype=np.int64), a(path_steps_flat, dtype=np.int64),
        a(ejump, dtype=np.int64), int(max_block_weight),
        int(max_block_path_length), int(max_path_jump),
        int(max_edge_jump), int(order_longest))
    try:
        nb = lib.bf_n_blocks(r)
        nr = lib.bf_n_ranges(r)
        block_off = np.zeros(nb + 1, dtype=np.int64)
        pid = np.zeros(max(nr, 1), dtype=np.int64)
        begin = np.zeros(max(nr, 1), dtype=np.int64)
        end = np.zeros(max(nr, 1), dtype=np.int64)
        length = np.zeros(max(nr, 1), dtype=np.int64)
        lib.bf_copy(r, block_off, pid, begin, end, length)
        return block_off, pid[:nr], begin[:nr], end[:nr], length[:nr]
    finally:
        lib.bf_free(r)


def unchop_arrays(seq_buf: np.ndarray, node_off: np.ndarray,
                  edges: np.ndarray, path_off: np.ndarray,
                  steps: np.ndarray, do_unchop: bool = True,
                  do_toposort: bool = True):
    """Run native unchop(+toposort+renumber); returns the same array tuple.
    Returns None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n_paths = len(path_off) - 1
    r = lib.gc_unchop(len(node_off) - 1, seq_buf, node_off, len(edges) // 2,
                      edges.reshape(-1), n_paths, path_off, steps,
                      int(do_unchop), int(do_toposort))
    return _take(lib, r, n_paths)


def block_unchop(base: np.ndarray, seq_off: np.ndarray,
                 seq_nodes: np.ndarray, pad: int, range_seq: np.ndarray,
                 range_rev: np.ndarray, cons: np.ndarray, has_cons: bool,
                 abpoa: bool, do_unchop: bool = True,
                 do_toposort: bool = True):
    """The block graph of a POA graph, unchopped and toposorted, in one
    native call (graphcore.cpp gc_block_unchop: the arguments are
    documented there); the same array tuple as unchop_arrays.  With both
    flags off it is the block graph before its unchop.  Returns None when
    the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n_paths = len(range_seq) + int(has_cons)
    r = lib.gc_block_unchop(len(base), base, len(seq_off) - 1, seq_off,
                            seq_nodes, int(pad), len(range_seq), range_seq,
                            range_rev, int(has_cons), len(cons), cons,
                            int(abpoa), int(do_unchop), int(do_toposort))
    return _take(lib, r, n_paths)


def _take(lib, r, n_paths: int):
    """Copy a gc_* result handle out as (seq_buf, node_off, edges,
    path_off, steps) and free it."""
    try:
        n2 = lib.gc_n_nodes(r)
        sl = lib.gc_seq_len(r)
        ne = lib.gc_n_edges(r)
        ns = lib.gc_n_steps(r)
        seq2 = np.zeros(max(sl, 1), dtype=np.uint8)
        off2 = np.zeros(n2 + 1, dtype=np.int64)
        edges2 = np.zeros(max(2 * ne, 1), dtype=np.int64)
        poff2 = np.zeros(n_paths + 1, dtype=np.int64)
        steps2 = np.zeros(max(ns, 1), dtype=np.int64)
        lib.gc_copy(r, seq2, off2, edges2, poff2, steps2, n_paths)
        return seq2[:sl], off2, edges2[:2 * ne], poff2, steps2[:ns]
    finally:
        lib.gc_free(r)
