"""The port's sanitizer lane, the counterpart of the JAX package's
tools/run_asan.sh and native/Makefile's asan builds (which stay the JAX
package's own), in three parts:

  --host  the host libraries csrc/host/{graphcore,cpoa,sgd,wfa}.cpp built
          under AddressSanitizer and UBSan (ops/_build.build_sanitized_host)
          and the port's tests of the host stages (HOST_TESTS) run against
          them in a child process with libasan, libubsan and libstdc++
          preloaded, leak checks off and SMOOTHXG_TORCH_NATIVE_DIR naming
          the sanitized builds;
  --emu   the ten kernel sources built for the CUDA emulation under the same
          sanitizers, with the emulated shared memory exactly the launch's
          bytes (testing/cuda_emu.build(..., sanitize=True)), and their
          emulation tests (EMU_TESTS) run on them;
  --card  on the card: tools/sanitize_drive.py, which launches every kernel
          entry of the CUDA library at a small size and holds it to its
          plain version, under compute-sanitizer's memcheck, racecheck,
          synccheck and initcheck (the toolkit's own, beside the nvcc that
          builds the kernels; PYTORCH_NO_CUDA_MEMORY_CACHING=1, so that
          every tensor is an allocation of its own), each in a child
          process, and beside them the same harness under the guard
          allocator of testing/guard_alloc.cu (guard bands and two poison
          bytes), which runs where compute-sanitizer does not.  Each child
          is killed past its time limit (TOOL_TIMEOUT, or run_card's
          `timeout`), and that fails the lane.  With --full also
          tests/test_torch_cuda.py (-m cuda --noconftest) under memcheck,
          or under the guard allocator where memcheck cannot run.

    python -m smoothxg_tpu_torch.tools.sanitize            # --host --emu
    python -m smoothxg_tpu_torch.tools.sanitize --card [--full]

A report fails the lane unless it is in EXPECTED: only initcheck reads of
slack that the kernel masks by design, and racecheck hazards on a flag
handoff that the memory model orders.  Exits nonzero on any other report,
on a test that fails, or on a guard band written.  The card part prints a
line a tool (version, seconds, kernels covered, reports) and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
# the port's tests of the host stages: the pipeline end to end (cpoa,
# graphcore, sgd's native prep, and wfa through the divergent fixture's
# split stage), graphcore's block-graph entry on its edge cases and the SGD
# layout's native route
HOST_TESTS = ["tests/test_torch_pipeline.py",
              "tests/test_torch_finalize_flat.py",
              "tests/test_torch_sgd.py::test_batched_routes_match_native_quality",
              "tests/test_torch_sgd.py::test_auto_routes_by_term_updates"]
# the emulation tests of the ten kernel sources
EMU_TESTS = ["tests/test_torch_kernel_emu.py", "tests/test_torch_chase_emu.py",
             "tests/test_torch_win_cluster_emu.py",
             "tests/test_torch_round_emu.py", "tests/test_torch_batch_emu.py",
             "tests/test_torch_probes.py::test_kernel_source_matches_plain_version",
             "tests/test_torch_sgd.py", "tests/test_torch_minhash.py",
             "tests/test_torch_ident.py", "tests/test_torch_autocorr.py"]
EMU_FILTER = "emu or emulated or source"
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the library's kernels (csrc/*.cu); compute-sanitizer checks these only
KERNELS = ("poa_win_kernel", "poa_win_cluster_kernel", "poa_code_kernel",
           "poa_stacked_kernel",
           "poa_round_kernel", "poa_batch_kernel", "sgd_plan_kernel",
           "sgd_chain_kernel", "minhash_hash_kernel", "minhash_inter_kernel",
           "minhash_inter_long_kernel", "ident_warp_kernel",
           "ident_block_kernel", "autocorr_pack_kernel",
           "autocorr_count_kernel", "probe_scalar_kernel", "probe_row_kernel",
           "probe_tile_kernel", "probe_step_block_kernel",
           "probe_step_warp_kernel")
KERNEL_REGEX = "|".join(KERNELS)
# the reports a clean run may show, by tool: (kernel, what the report
# says, why it is not a fault)
EXPECTED = {
    "initcheck": [
        ("autocorr_count_kernel", "Uninitialized __global__ memory read",
         "stage() copies a unit's plane words 16 bytes at a time, unguarded "
         "(csrc/autocorr.cu:316): words past a row's length and past the "
         "last row are read but always masked"),
    ],
    "racecheck": [],
}
TOOL_TIMEOUT = 600


def _echo(msg: str) -> None:
    print(f"[sanitize] {msg}", flush=True)


# ---------------------------------------------------------------------------
# host and emulation parts (the CPU)
# ---------------------------------------------------------------------------

def preload() -> str:
    """LD_PRELOAD of a process that loads sanitized libraries into a Python
    that was not built with them: libasan, libubsan and libstdc++ (without
    libstdc++ the ASan interceptor of __cxa_throw stays null and the first
    C++ throw aborts; tools/run_asan.sh:22-27)."""
    cxx = os.environ.get("CXX", "g++")
    return " ".join(subprocess.run([cxx, f"-print-file-name={lib}"],
                                   capture_output=True, text=True,
                                   check=True).stdout.strip()
                    for lib in ("libasan.so", "libubsan.so",
                                "libstdc++.so.6"))


def host_env(native_dir: str) -> dict:
    """The environment of a child process that runs the port against the
    sanitized host libraries in `native_dir`."""
    from ..ops._build import NATIVE_DIR_ENV
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, LD_PRELOAD=preload(),
                ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
                UBSAN_OPTIONS="print_stacktrace=1",
                **{NATIVE_DIR_ENV: native_dir}, JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def _pytest(args: list, env: dict, workers: int) -> int:
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           *(["-n", str(workers), "--dist", "loadfile"] if workers > 1
             else []), *args]
    _echo(" ".join(cmd))
    return subprocess.run(cmd, cwd=REPO, env=env).returncode


def run_host() -> int:
    from ..ops._build import build_sanitized_host
    t0 = time.perf_counter()
    d = build_sanitized_host()
    _echo(f"host: sanitized libraries in {d} "
          f"({time.perf_counter() - t0:.1f} s)")
    return _pytest(HOST_TESTS, host_env(d), 1)


def run_emu() -> int:
    from ..testing.cuda_emu import SANITIZE_ENV
    env = dict(os.environ, **{SANITIZE_ENV: "1"}, JAX_PLATFORMS="cpu")
    return _pytest([*EMU_TESTS, "-k", EMU_FILTER], env, 4)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def compute_sanitizer() -> str | None:
    """compute-sanitizer of the toolkit whose nvcc builds the kernels
    (ops/_build._nvcc), or None where that toolkit has none."""
    from ..ops._build import _nvcc
    root = os.path.dirname(os.path.dirname(os.path.realpath(_nvcc())))
    for cand in (os.path.join(root, "bin", "compute-sanitizer"),
                 os.path.join(root, "compute-sanitizer",
                              "compute-sanitizer")):
        if os.access(cand, os.X_OK):
            return cand
    return None


def tool_version(cs: str) -> str:
    out = subprocess.run([cs, "--version"], capture_output=True, text=True,
                         timeout=60).stdout
    m = re.search(r"Version (\S+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1:][0]


_REPORT = re.compile(
    r"^========= (Invalid |Uninitialized |Barrier error|Race reported|"
    r"(ERROR|Error|Warning): (Potential|Race|Detected|Invalid)|"
    r"Program hit |Divergent |Malformed |Misaligned |Out-of-range )")


def parse_reports(text: str) -> list:
    """The reports in a compute-sanitizer log: [{"kind": its first line,
    "kernel": the library kernel it names or None}], one a block of lines
    that starts with a report line."""
    reports, cur = [], None
    for line in text.splitlines():
        if _REPORT.match(line):
            cur = {"kind": line[10:].strip(),
                   "kernel": next((k for k in KERNELS if k in line), None)}
            reports.append(cur)
        elif cur is not None and line.strip() in ("=========", ""):
            cur = None
        elif cur is not None and cur["kernel"] is None:
            cur["kernel"] = next((k for k in KERNELS if k in line), None)
    return reports


def expected(tool: str, report: dict) -> str | None:
    """Why `report` is expected of `tool`, or None."""
    for kernel, says, why in EXPECTED.get(tool, ()):
        if report["kernel"] == kernel and says in report["kind"]:
            return why
    return None


def _drive_cmd(guard: str | None = None, pytest_args=None) -> list:
    cmd = [sys.executable, "-m", "smoothxg_tpu_torch.tools.sanitize_drive"]
    if guard:
        cmd += ["--guard", guard]
    if pytest_args:
        cmd += ["--pytest", *pytest_args]
    return cmd


def _result(out: str):
    """The harness's JSON line, or None."""
    for line in reversed(out.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def _timed_out(err: subprocess.TimeoutExpired) -> str:
    """What a child killed at its time limit had written."""
    return "".join(x.decode(errors="replace") if isinstance(x, bytes) else x
                   for x in (err.stdout, err.stderr) if x)


def run_tool(cs: str, tool: str, target: list, log_dir: str,
             timeout: float = TOOL_TIMEOUT) -> dict:
    """One compute-sanitizer tool over `target` in a child process; a run
    past `timeout` seconds is killed and fails."""
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    # (--kernel-regex: deprecated in 2025.2 for --kernel-name, but taken);
    # memcheck pads every allocation, so that an overrun into a neighbouring
    # one is seen too
    cmd = [cs, "--tool", tool, "--error-exitcode", "1", "--kernel-regex",
           f"kns={KERNEL_REGEX}",
           *(["--padding", "64"] if tool == "memcheck" else []), *target]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired as err:
        with open(os.path.join(log_dir, f"{tool}.log"), "w") as f:
            f.write(_timed_out(err))
        return {"tool": tool, "rc": None, "seconds": round(timeout, 2),
                "supported": True, "reports": None, "unexpected": [],
                "kernels": [], "drive_ok": None, "ok": False,
                "note": f"did not end in {timeout:.0f} s"}
    secs = time.perf_counter() - t0
    text = res.stdout + res.stderr
    with open(os.path.join(log_dir, f"{tool}.log"), "w") as f:
        f.write(text)
    out = {"tool": tool, "rc": res.returncode, "seconds": round(secs, 2)}
    if "Device not supported" in text:
        line = next(ln for ln in text.splitlines()
                    if "Device not supported" in ln)
        return {**out, "supported": False, "note": line.strip("= ")}
    reports = parse_reports(text)
    unexpected = [r for r in reports if expected(tool, r) is None]
    drive = _result(res.stdout) or {}
    covered = sorted(k for k, v in drive.get("launches", {}).items() if v)
    # the harness held every entry to its plain version, and the tool's
    # nonzero exit (if any) came from reports it printed, all expected
    ok = drive.get("ok") is True and not unexpected and \
        (res.returncode == 0 or bool(reports))
    return {**out, "supported": True, "reports": len(reports),
            "unexpected": unexpected[:20], "kernels": covered,
            "drive_ok": drive.get("ok"), "ok": bool(ok)}


def build_guard() -> str:
    """testing/guard_alloc.cu built with nvcc into _build/ (keyed by its
    bytes); returns the library."""
    import hashlib
    from ..ops._build import ARCH, BUILD_DIR, _nvcc
    src = os.path.join(_PKG, "testing", "guard_alloc.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libguard_alloc_{key}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp"
        res = subprocess.run([_nvcc(), *ARCH, "-O2", "-shared", "-Xcompiler",
                              "-fPIC", "-o", tmp, src], capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on guard_alloc.cu:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, path)
    return path


def run_guard(guard: str, pytest_args=None,
              timeout: float = TOOL_TIMEOUT) -> dict:
    """The harness (or pytest) in a child process on the guard allocator;
    a run past `timeout` seconds is killed and fails."""
    t0 = time.perf_counter()
    try:
        res = subprocess.run(_drive_cmd(guard, pytest_args), cwd=REPO,
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as err:
        return {"tool": "guard", "rc": None, "seconds": round(timeout, 2),
                "violations": None, "first": None, "allocations": None,
                "kernels": [], "failed": [], "ok": False,
                "tail": f"did not end in {timeout:.0f} s:\n"
                        + _timed_out(err)[-3000:]}
    secs = time.perf_counter() - t0
    drive = _result(res.stdout) or {}
    g = drive.get("guard") or {}
    return {"tool": "guard", "rc": res.returncode, "seconds": round(secs, 2),
            "violations": g.get("violations"), "first": g.get("first"),
            "allocations": g.get("allocations"),
            "kernels": sorted(k for k, v in drive.get("launches", {}).items()
                              if v),
            "failed": [e for e in drive.get("entries", ()) if not e["ok"]],
            "ok": res.returncode == 0 and drive.get("ok") is True,
            "tail": "" if res.returncode == 0 else
            (res.stdout + res.stderr)[-3000:]}


def run_card(full: bool = False, echo=_echo, log_dir: str | None = None,
             timeout: float = TOOL_TIMEOUT) -> dict:
    """The card part, each child process limited to `timeout` seconds;
    returns {"ok", "tools": [...], "guard": {...}, "full": {...} or None,
    "version", "path"}."""
    from ..ops import _build
    log_dir = log_dir or os.path.join(REPO, "smoke_out", "sanitize")
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    _build.build()
    guard = build_guard()
    echo(f"sanitizers: kernels and guard allocator built "
         f"({time.perf_counter() - t0:.1f} s)")
    for tool, rows in EXPECTED.items():
        for kernel, says, why in rows:
            echo(f"sanitizers: expected of {tool}: {kernel}, \"{says}\": "
                 f"{why}")
    cs = compute_sanitizer()
    out = {"path": cs, "version": tool_version(cs) if cs else None,
           "tools": [], "full": None}
    # the four tools and the guard allocator at once, each in its own
    # process on the card
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(TOOLS) + 1) as pool:
        guard_run = pool.submit(run_guard, guard, None, timeout)
        runs = [pool.submit(run_tool, cs, t, _drive_cmd(), log_dir, timeout)
                for t in (TOOLS if cs else ())]
        out["tools"] = [r.result() for r in runs]
        out["guard"] = guard_run.result()
    if cs is None:
        echo("sanitizers: the toolkit beside nvcc has no compute-sanitizer")
    else:
        for r in out["tools"]:
            if not r["supported"]:
                echo(f"sanitizers: {r['tool']} (compute-sanitizer "
                     f"{out['version']}): not run on this card: "
                     f"{r['note']} ({r['seconds']:.1f} s)")
            elif "note" in r:
                echo(f"sanitizers: {r['tool']} (compute-sanitizer "
                     f"{out['version']}): {r['note']}, killed; its output "
                     f"so far in {log_dir}")
            else:
                echo(f"sanitizers: {r['tool']} (compute-sanitizer "
                     f"{out['version']}): {r['seconds']:.1f} s, kernels "
                     f"{len(r['kernels'])} {r['kernels']}, reports "
                     f"{r['reports']}, unexpected {len(r['unexpected'])} "
                     f"{r['unexpected'][:3]}")
    g = out["guard"]
    echo(f"sanitizers: guard allocator (bands of 4 KB, poisons 0x00 and "
         f"0xff in memory and shared memory): {g['seconds']:.1f} s, kernels "
         f"{len(g['kernels'])} {g['kernels']}, {g['allocations']} "
         f"allocations, violations {g['violations']}"
         + (f" (first: {g['first']})" if g["violations"] else "")
         + (f", failed entries {g['failed']}" if g["failed"] else "")
         + (f"\n{g['tail']}" if g["tail"] else ""))
    if full:
        args = ["-q", "-p", "no:cacheprovider", "--noconftest", "-m", "cuda",
                "tests/test_torch_cuda.py"]
        memcheck = [r for r in out["tools"]
                    if r["tool"] == "memcheck" and r["supported"]]
        if memcheck:
            out["full"] = run_tool(cs, "memcheck", _drive_cmd(None, args),
                                   log_dir, timeout)
        else:
            out["full"] = run_guard(guard, args, timeout)
        f = out["full"]
        echo(f"sanitizers: tests/test_torch_cuda.py under {f['tool']}: "
             f"{f['seconds']:.1f} s, rc {f['rc']}"
             + (f", violations {f['violations']}" if f["tool"] == "guard"
                else f", reports {f.get('reports')}")
             + (f"\n{f['tail']}" if f.get("tail") else ""))
    runs = [r for r in out["tools"] if r["supported"]] + [out["guard"]] + \
        ([out["full"]] if out["full"] else [])
    out["ok"] = all(r["ok"] for r in runs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--emu", action="store_true")
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="with --card: tests/test_torch_cuda.py too")
    args = ap.parse_args(argv)
    if not (args.host or args.emu or args.card):
        args.host = args.emu = True
    rc = 0
    if args.host:
        rc |= run_host()
    if args.emu:
        rc |= run_emu()
    if args.card:
        res = run_card(args.full)
        print(json.dumps(res), flush=True)
        rc |= 0 if res["ok"] else 1
    _echo("OK" if rc == 0 else "FAILED")
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
