"""The card half of the port's sanitizer lane (tools/sanitize.py --card and
its harness tools/sanitize_drive.py), as far as it runs on the CPU:

* the harness's entries run on the CPU, where each wrapper takes its plain
  version (a rehearsal of the harness's own code: shapes, packing, calls);
* compute-sanitizer's reports are read from its log (memcheck, racecheck,
  synccheck and initcheck lines, with the library kernel each names), and
  only those of tools/sanitize.EXPECTED pass;
* run_tool, through a stand-in for compute-sanitizer: a tool that cannot
  run on the card is told apart from a clean run, an expected report
  passes, an unexpected one or a harness that disagrees with its plain
  version fails.
The runs on the card: chip_smoke.py's phase 23 and tools/sanitize.py
--card [--full]."""
import json
import os
import stat
import sys

import pytest
import torch

from smoothxg_tpu_torch.tools import sanitize, sanitize_drive

MEMCHECK = """========= COMPUTE-SANITIZER
========= Invalid __global__ read of size 16 bytes
=========     at void poa_win_kernel<true, false>(const signed char *, const int *)+0x1a0 in poa_win.cu:300
=========     by thread (3,0,0) in block (1,0,0)
=========     Address 0x7f00 is out of bounds
=========
========= Program hit cudaErrorLaunchFailure (error 719) on CUDA API call to cudaDeviceSynchronize.
=========
========= ERROR SUMMARY: 2 errors
"""
RACECHECK = """========= Error: Race reported between Write access at void poa_batch_kernel<true, true>(const int *)+0x30 in poa_batch.cu:560
=========     and Read access at void poa_batch_kernel<true, true>(const int *)+0x50 in poa_batch.cu:570 [248 hazards]
=========
========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)
"""
INITCHECK = """========= Uninitialized __global__ memory read of size 16 bytes
=========     at void autocorr_count_kernel(const unsigned char *)+0x900 in autocorr.cu:316
=========     by thread (0,0,0) in block (0,0,0)
=========
========= Barrier error detected. Divergent thread(s) in block
=========     at void sgd_chain_kernel(float *, Plan, int)+0x40 in sgd.cu:227
=========
========= ERROR SUMMARY: 2 errors
"""


def test_reports_are_read_with_their_kernels():
    assert sanitize.parse_reports(MEMCHECK) == [
        {"kind": "Invalid __global__ read of size 16 bytes",
         "kernel": "poa_win_kernel"},
        {"kind": "Program hit cudaErrorLaunchFailure (error 719) on CUDA "
                 "API call to cudaDeviceSynchronize.", "kernel": None}]
    (race,) = sanitize.parse_reports(RACECHECK)
    assert race["kernel"] == "poa_batch_kernel"
    init, sync = sanitize.parse_reports(INITCHECK)
    assert (init["kernel"], sync["kernel"]) == ("autocorr_count_kernel",
                                                "sgd_chain_kernel")
    assert sanitize.parse_reports("========= COMPUTE-SANITIZER\n"
                                  "========= ERROR SUMMARY: 0 errors\n") == []


def test_only_the_listed_reports_are_expected():
    init, sync = sanitize.parse_reports(INITCHECK)
    assert sanitize.expected("initcheck", init)
    assert sanitize.expected("memcheck", init) is None
    assert sanitize.expected("synccheck", sync) is None
    assert sanitize.expected("racecheck",
                             sanitize.parse_reports(RACECHECK)[0]) is None
    assert set(sanitize.EXPECTED) <= {"initcheck", "racecheck"}
    assert set(sanitize.KERNELS) >= {k for rows in sanitize.EXPECTED.values()
                                     for k, _, _ in rows}


def test_regex_names_every_kernel_of_the_library():
    import re
    src = os.path.join(os.path.dirname(sanitize.__file__), os.pardir,
                       "csrc")
    names = set()
    for f in os.listdir(src):
        if f.endswith(".cu"):
            text = open(os.path.join(src, f)).read()
            names |= set(re.findall(r"__global__ void(?: __launch_bounds__"
                                    r"\([^)]*\))?\s+(\w+)", text))
    assert names == set(sanitize.KERNELS)


def _fake_tool(tmp_path, log: str) -> str:
    """A stand-in for compute-sanitizer: prints `log` and runs the target
    (from the Python executable on), exiting 1 where the log has
    reports."""
    path = tmp_path / "compute-sanitizer"
    path.write_text(
        f"#!{sys.executable}\n"
        "import subprocess, sys\n"
        f"target = sys.argv[sys.argv.index({sys.executable!r}):]\n"
        f"print({log!r}, end='')\n"
        "rc = subprocess.run(target).returncode\n"
        f"sys.exit(rc or {int(bool(sanitize.parse_reports(log)))})\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _target(ok: bool) -> list:
    res = {"ok": ok, "entries": [], "launches": {"autocorr": 2, "ident": 0}}
    return [sys.executable, "-c", f"print({json.dumps(json.dumps(res))})"]


@pytest.mark.parametrize("log,tool,drive_ok,want", [
    ("========= ERROR SUMMARY: 0 errors\n", "memcheck", True, True),
    (INITCHECK.split("=========\n")[0] + "=========\n", "initcheck", True,
     True),
    (INITCHECK, "initcheck", True, False),
    (RACECHECK, "racecheck", True, False),
    ("========= ERROR SUMMARY: 0 errors\n", "synccheck", False, False),
])
def test_run_tool_passes_clean_and_expected_runs_only(tmp_path, log, tool,
                                                      drive_ok, want):
    res = sanitize.run_tool(_fake_tool(tmp_path, log), tool,
                            _target(drive_ok), str(tmp_path))
    assert res["supported"] and res["ok"] is want
    assert res["kernels"] == ["autocorr"]
    assert os.path.exists(tmp_path / f"{tool}.log")


def test_run_tool_tells_a_card_it_cannot_check(tmp_path):
    log = ("========= COMPUTE-SANITIZER\n========= Error: Device not "
           "supported. Please refer to the \"Supported Devices\" section\n")
    res = sanitize.run_tool(_fake_tool(tmp_path, log), "memcheck",
                            _target(False), str(tmp_path))
    assert not res["supported"] and "Device not supported" in res["note"]


def test_harness_entries_run_their_plain_versions_on_the_cpu():
    lines = []
    res = sanitize_drive.run(torch.device("cpu"),
                             echo=lambda m, **_: lines.append(m))
    assert res["ok"], [e for e in res["entries"] if not e["ok"]]
    assert len(res["entries"]) == len(sanitize_drive.ENTRIES) == 11
    assert set(res["launches"]) == set(sanitize_drive.wrappers())
    assert not any(res["launches"].values())      # no kernel on the CPU
    assert len(lines) == 11
