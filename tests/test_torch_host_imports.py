"""The port's host stages keep torch out of the interpreter (ROADMAP C16), as
the JAX package keeps jax out of the same modules: importing each of them in
a fresh interpreter leaves "torch" out of sys.modules, and after a `-t 2`
CPU run with --engine native no worker of the spawn pool has loaded torch.
Every `-t N` worker imports the CLI again as its main module and unpickles
tasks of pipeline.breaks, .smooth and .consensus_graph, so a torch import in
any of them would be paid once a worker.  Each check runs in a child
interpreter, so this process's own pool and imports stay out of it."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_MODULES = [
    "cli",
    "pipeline.run", "pipeline.prep", "pipeline.blocks", "pipeline.breaks",
    "pipeline.smooth", "pipeline.lace", "pipeline.merge", "pipeline.maf",
    "pipeline.consensus_graph", "pipeline.poolidx",
    "utils.procpool", "utils.progress", "utils.spans",
    "ops.autocorr", "ops.poa_host", "ops.poa_fused",
]

IMPORT = """
import importlib, json, sys
importlib.import_module("smoothxg_tpu_torch." + sys.argv[1])
print(json.dumps("torch" in sys.modules))
"""


@pytest.fixture(scope="module")
def imports():
    """torch loaded (True / False) after importing each module alone; the
    interpreters run side by side."""
    procs = {m: subprocess.Popen([sys.executable, "-c", IMPORT, m], cwd=REPO,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in HOST_MODULES}
    out = {}
    for m, p in procs.items():
        so, se = p.communicate(timeout=120)
        assert p.returncode == 0, se[-2000:]
        out[m] = json.loads(so.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_module_imports_without_torch(imports, module):
    assert imports[module] is False, \
        f"importing smoothxg_tpu_torch.{module} loads torch"


# A script run as the main module, as the CLI is: spawn imports it again in
# every worker (as __mp_main__), so `probe` reaches the workers by name.
WORKERS = """
import os, sys, time
sys.path.insert(0, {repo!r})
from smoothxg_tpu_torch import cli


def probe():
    time.sleep(0.2)     # hold this worker so the next probe finds another
    return (os.getpid(), "torch" in sys.modules,
            "smoothxg_tpu_torch.pipeline.breaks" in sys.modules,
            "smoothxg_tpu_torch.pipeline.smooth" in sys.modules)


if __name__ == "__main__":
    import json
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    from smoothxg_tpu_torch.utils import procpool
    d = {tmp!r}
    g = write_pangenome(d + "/in.gfa", haplotypes=4, length=3000, seed=3)
    assert cli.main(["-g", g, "-o", d + "/out.gfa", "-m", d + "/out.maf",
                     "-r", "4", "-l", "700", "-t", "2",
                     "--engine", "native"]) == 0
    pool = procpool.get_pool(2)
    pids = set(pool._processes)
    seen = {{}}
    deadline = time.monotonic() + 30
    while set(seen) != pids and time.monotonic() < deadline:
        for f in [pool.submit(probe) for _ in range(len(pids))]:
            pid, *flags = f.result(timeout=30)
            seen[pid] = flags
    print(json.dumps({{"parent_torch": "torch" in sys.modules,
                      "workers": sorted(pids),
                      "seen": {{str(k): v for k, v in seen.items()}}}}))
"""


def test_pool_workers_of_a_native_run_never_load_torch(tmp_path):
    script = tmp_path / "run_t2.py"
    script.write_text(WORKERS.format(repo=REPO, tmp=str(tmp_path)))
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["workers"]) == 2
    assert sorted(map(int, out["seen"])) == out["workers"]
    for pid, (torch_loaded, breaks, smooth) in out["seen"].items():
        # the worker served the run: it holds the stages' modules
        assert breaks and smooth, pid
        assert torch_loaded is False, f"worker {pid} loaded torch"
