"""The port's host-sync lint (presto_tpu_torch/analysis/lint.py): the
shipped port tree is clean -- every device->host transfer is a pragma'd
sync point -- each hazard shape is detected on a torch-idiom fixture,
and the rules the two packages share find the same sites as the JAX
package's lint on the same source under the same layer paths."""
import os
import subprocess
import sys

import pytest

from presto_tpu.analysis import lint as jlint
from presto_tpu_torch.analysis.lint import (
    ALL_LINT_CODES, KERNEL_PLAIN, MEM_PRAGMA, MEM_UNCHARGED_STAGING,
    NET_NO_TIMEOUT, NET_PRAGMA, PRAGMA, SYNC_ASARRAY, SYNC_BRANCH,
    SYNC_CAST, SYNC_EXPLICIT, SYNC_NETWORK, SYNC_WALLCLOCK,
    TELEM_UNBOUNDED_QUEUE, WALL_PRAGMA, lint_or_raise, lint_paths,
    lint_source)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "presto_tpu_torch"


def _codes(findings):
    return {f.code for f in findings}


# -- the gate: the shipped port tree is clean --------------------------------

def test_shipped_port_tree_is_clean():
    findings = lint_paths([os.path.join(REPO, PKG)])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_module_entry_point_exit_codes(tmp_path):
    clean = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis.lint", PKG],
        cwd=REPO, capture_output=True, text=True)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    fixture = tmp_path / "bad.py"
    fixture.write_text("import torch\n"
                       "def f(x):\n"
                       "    return torch.sum(x).item()\n")
    bad = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis.lint", str(fixture)],
        cwd=REPO, capture_output=True, text=True)
    assert bad.returncode == 1 and "SYNC001" in bad.stdout


def test_ci_entry_point_exits_clean(tmp_path):
    import json
    report_path = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis.ci", "--max-plans", "3",
         "--json", str(report_path)], cwd=REPO, capture_output=True,
        text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(report_path.read_text())
    assert report["clean"] is True and report["total_findings"] == 0
    assert report["files_scanned"] > 100
    assert report["plan_sweep"]["queries"] == 3
    assert report["lint"]["findings"] == []
    assert report["concurrency"]["findings"] == []


# -- SYNC001-004 in torch idiom ----------------------------------------------

@pytest.mark.parametrize("src", [
    "import torch\ndef f(x):\n    s = torch.sum(x)\n    return s.item()\n",
    "def f(x):\n    return x.cpu()\n",
    "import torch\ndef f(x):\n    return torch.cumsum(x, 0).tolist()\n",
    "import torch\ndef f(x):\n    y = torch.where(x > 0, x, 0)\n"
    "    return y.numpy()\n",
    "import torch\ndef f():\n    torch.cuda.synchronize()\n",
    "def f(ev):\n    ev.synchronize()\n",
    "import torch\ndef f():\n    torch.cuda.current_stream().synchronize()\n",
], ids=["item", "cpu", "tolist", "numpy", "cuda_synchronize",
        "event_synchronize", "stream_synchronize"])
def test_explicit_sync_flagged(src):
    assert _codes(lint_source(src)) == {SYNC_EXPLICIT}


def test_host_tolist_and_numpy_not_flagged():
    """.tolist() / .numpy() of a host value (a numpy array, a copied
    tensor) are not transfers."""
    findings = lint_source(
        "import numpy as np\n"
        "import torch\n"
        "def f(a, t):\n"
        "    h = torch.from_numpy(a)\n"
        "    return np.arange(3).tolist(), h.numpy(), a.tolist()\n")
    assert findings == []


def test_cast_of_device_value_flagged():
    findings = lint_source(
        "import torch\n"
        "def f(x):\n"
        "    return float(torch.mean(x)), int(torch.sum(x))\n")
    assert _codes(findings) == {SYNC_CAST} and len(findings) == 2


def test_cast_tracks_assigned_names_and_methods():
    findings = lint_source(
        "import torch\n"
        "def f(x):\n"
        "    total = torch.sum(x) + 1\n"
        "    live = total.to(torch.int64)\n"
        "    return int(live), bool(total.any())\n")
    assert _codes(findings) == {SYNC_CAST} and len(findings) == 2


def test_np_asarray_on_device_value_flagged():
    findings = lint_source(
        "import numpy as np\n"
        "import torch\n"
        "def f(x):\n"
        "    y = torch.where(x > 0, x, 0)\n"
        "    return np.asarray(y), np.array(y)\n")
    assert _codes(findings) == {SYNC_ASARRAY} and len(findings) == 2


def test_branch_on_device_bool_flagged():
    findings = lint_source(
        "import torch\n"
        "def f(x):\n"
        "    if torch.any(x > 0):\n"
        "        return 1\n"
        "    while torch.all(x):\n"
        "        pass\n")
    assert _codes(findings) == {SYNC_BRANCH} and len(findings) == 2


def test_copied_value_is_host():
    """A value copied with .cpu() / .item() is host: only the copy needs
    the pragma, casting and branching on its result do not."""
    findings = lint_source(
        "import torch\n"
        "def f(x):\n"
        "    v = torch.sum(x).cpu()  # lint: allow-host-sync\n"
        "    n = torch.count_nonzero(x).item()  # lint: allow-host-sync\n"
        "    if int(v) > n:\n"
        "        return float(v)\n")
    assert findings == []


def test_metadata_and_host_namespaces_are_host():
    findings = lint_source(
        "import torch\n"
        "def f(x, a):\n"
        "    if torch.is_floating_point(x) and torch.cuda.is_available():\n"
        "        return int(torch.iinfo(torch.int32).max) + int(x.shape[0])\n"
        "    p = torch.cuda.get_device_properties(0)\n"
        "    if p.multi_processor_count > 1:\n"
        "        return int(torch.from_numpy(a).sum())\n")
    assert findings == []


def test_plain_python_casts_not_flagged():
    assert lint_source("def f(args):\n"
                       "    return int(args[1].value), float('3')\n") == []


def test_pragma_suppresses_and_covers_multiline():
    assert lint_source(
        "import torch\n"
        "def f(x):\n"
        "    return bool(torch.any(x))  # lint: allow-host-sync\n") == []
    assert lint_source(
        "def f(x, y):\n"
        "    return (x + y).cpu(  # lint: allow-host-sync\n"
        "        )\n") == []


def test_syntax_error_is_reported_not_raised():
    assert [f.code for f in lint_source("def f(:\n")] == ["SYNTAX"]


def test_lint_routes_through_error_taxonomy(tmp_path):
    from presto_tpu_torch.common.errors import (PlanValidationError,
                                                is_retryable)
    fixture = tmp_path / "bad.py"
    fixture.write_text("import torch\n"
                       "def f(x):\n"
                       "    return torch.sum(x).item()\n")
    with pytest.raises(PlanValidationError) as ei:
        lint_or_raise([str(fixture)])
    assert ei.value.diagnostics and not is_retryable(ei.value)
    lint_or_raise([os.path.join(REPO, PKG)])       # clean: no raise


# -- KERNEL001: plain versions stay off the main path ------------------------

_PLAIN_CALL = ("from .kernels.window import window_scan_plain\n"
               "def f(*a):\n"
               "    return window_scan_plain(*a)\n")


@pytest.mark.parametrize("path", [
    f"{PKG}/exec/pipeline.py", f"{PKG}/exec/kernels/grouped.py",
    f"{PKG}/worker/task.py"])
def test_plain_version_call_outside_its_module_flagged(path):
    assert _codes(lint_source(_PLAIN_CALL, path)) == {KERNEL_PLAIN}
    # attribute calls too, and no pragma escape
    src = ("from .kernels import scan_kernel as sk\n"
           "def f(*a):\n"
           "    return sk.scan_direct_plain(*a)  # lint: allow-host-sync\n")
    assert _codes(lint_source(src, path)) == {KERNEL_PLAIN}


def test_plain_version_in_its_own_module_and_harnesses_not_flagged():
    own = ("def window_scan_plain(*a):\n"
           "    return a\n"
           "def window_scan(*a):\n"
           "    return window_scan_plain(*a)\n")
    assert lint_source(own, f"{PKG}/exec/kernels/window.py") == []
    assert lint_source(_PLAIN_CALL, f"{PKG}/benchmarks/hive_run.py") == []


def test_shipped_tree_calls_plain_versions_only_in_their_modules():
    """Each *_plain call of the port sits beside its definition."""
    import ast
    for root, _d, files in os.walk(os.path.join(REPO, PKG)):
        if "benchmarks" in root:
            continue
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, fn)).read())
            defined = {n.name for n in ast.walk(tree)
                       if isinstance(n, ast.FunctionDef)}
            for n in ast.walk(tree):
                if isinstance(n, ast.Call):
                    name = jlint._dotted(n.func).rsplit(".", 1)[-1]
                    if name.endswith("_plain"):
                        assert name in defined, (fn, name)


# -- the rules the packages share: same findings on the same source ----------

_NET_FIXTURE = ("import urllib.request\n"
                "def fetch(url):\n"
                "    return urllib.request.urlopen(url).read()\n")
_WALL_FIXTURE = ("import time\n"
                 "def drive(batches):\n"
                 "    t0 = time.perf_counter()\n"
                 "    n = sum(1 for _ in batches)\n"
                 "    return n, time.perf_counter() - t0\n")
_MEM_FIXTURE = ("class BucketStager:\n"
                "    def __init__(self):\n"
                "        self.pending_pages = []\n"
                "        self._chunks: dict = {}\n"
                "    def add(self, b):\n"
                "        self.pending_pages.append(b)\n")
_QUEUE_FIXTURE = ("import queue\n"
                  "a = queue.Queue()\n"
                  "b = queue.Queue(maxsize=0)\n"
                  "c = queue.SimpleQueue()\n"
                  "ok1 = queue.Queue(maxsize=256)\n"
                  "ok2 = queue.Queue(128)\n")
_SHARED = [
    (_NET_FIXTURE, "exec/bad_net.py"), (_NET_FIXTURE, "worker/exchange.py"),
    (_NET_FIXTURE, "worker/coordinator.py"),
    (_NET_FIXTURE, "telemetry/export.py"),
    (_NET_FIXTURE, "telemetry/history.py"), (_NET_FIXTURE, "sql/planner.py"),
    (_NET_FIXTURE.replace("(url)", "(url, timeout=5)"), "worker/server.py"),
    (_NET_FIXTURE.replace(".read()", "  # lint: allow-no-timeout"),
     "worker/server.py"),
    (_WALL_FIXTURE, "exec/bad_timer.py"), (_WALL_FIXTURE, "worker/task.py"),
    (_WALL_FIXTURE.replace("counter()\n", "counter()  # lint: "
                           "allow-wall-clock\n"), "exec/scheduler.py"),
    (_MEM_FIXTURE, "exec/stager.py"), (_MEM_FIXTURE, "worker/stager.py"),
    (_MEM_FIXTURE, "sql/planner.py"),
    (_MEM_FIXTURE.replace("= []", "= []  # lint: allow-uncharged-staging"),
     "exec/stager.py"),
    (_QUEUE_FIXTURE, "telemetry/export.py"),
    (_QUEUE_FIXTURE, "exec/local_exchange.py"),
]


@pytest.mark.parametrize("src,sub", _SHARED,
                         ids=[f"{i}-{p}" for i, (_s, p) in enumerate(_SHARED)])
def test_shared_rules_match_the_reference(src, sub):
    got = [(f.line, f.code) for f in lint_source(src, f"{PKG}/{sub}")]
    want = [(f.line, f.code)
            for f in jlint.lint_source(src, f"presto_tpu/{sub}")]
    assert got == want
    assert {c for _l, c in got} <= {SYNC_NETWORK, NET_NO_TIMEOUT,
                                     SYNC_WALLCLOCK, MEM_UNCHARGED_STAGING,
                                     TELEM_UNBOUNDED_QUEUE}


def test_pragmas_are_not_interchangeable():
    findings = lint_source(
        "import time\n"
        "def f():\n"
        "    return time.perf_counter()  # lint: allow-host-sync\n",
        path=f"{PKG}/exec/whatever.py")
    assert _codes(findings) == {SYNC_WALLCLOCK}
    findings = lint_source(
        "def f(x):\n"
        "    return x.cpu()  # lint: allow-wall-clock\n",
        path=f"{PKG}/exec/whatever.py")
    assert _codes(findings) == {SYNC_EXPLICIT}


def test_all_codes_are_exercised_above():
    assert set(ALL_LINT_CODES) == {
        SYNC_EXPLICIT, SYNC_CAST, SYNC_ASARRAY, SYNC_BRANCH, SYNC_NETWORK,
        SYNC_WALLCLOCK, KERNEL_PLAIN, TELEM_UNBOUNDED_QUEUE,
        MEM_UNCHARGED_STAGING, NET_NO_TIMEOUT}
    assert (PRAGMA, WALL_PRAGMA, MEM_PRAGMA, NET_PRAGMA) == (
        jlint.PRAGMA, jlint.WALL_PRAGMA, jlint.MEM_PRAGMA, jlint.NET_PRAGMA)
