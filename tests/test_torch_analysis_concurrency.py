"""The port's thread-safety pass (presto_tpu_torch/analysis/concurrency.py):
the shipped port tree is clean, every fixture of the JAX package's
concurrency tests gives the same findings in both packages (those with a
JAX device sync get a torch twin), and LOCK002 knows the torch device
syncs."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from presto_tpu.analysis import concurrency as jconc
from presto_tpu_torch.analysis.concurrency import (ALL_CONCURRENCY_CODES,
                                                   LOCK_BLOCKING_HELD,
                                                   LOCK_IN_CALLBACK,
                                                   LOCK_ORDER,
                                                   LOCK_UNGUARDED,
                                                   PRAGMA_BLOCKING,
                                                   check_or_raise,
                                                   check_paths, check_source)
from presto_tpu_torch.common.errors import PlanValidationError
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _fixtures():
    """The string fixtures the reference's tests pass to check_source."""
    tree = ast.parse((REPO / "tests" / "test_analysis_concurrency.py")
                     .read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "check_source"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                out.append((fn.name, node.args[0].value))
    return out


FIXTURES = _fixtures()
JAX_SYNC = ("jax.", "block_until_ready")


def _sites(findings):
    return [(f.line, f.code) for f in findings]


def test_fixtures_found():
    assert len(FIXTURES) >= 15
    codes = set()
    for _n, src in FIXTURES:
        codes |= {f.code for f in jconc.check_source(src)}
    assert codes == set(ALL_CONCURRENCY_CODES)


@pytest.mark.parametrize(
    "name,src", [f for f in FIXTURES
                 if not any(m in f[1] for m in JAX_SYNC)],
    ids=lambda v: v if isinstance(v, str) and v.startswith("test_") else "")
def test_same_findings_as_the_reference(name, src):
    assert _sites(check_source(src)) == _sites(jconc.check_source(src))


def test_shipped_port_tree_is_clean():
    findings = check_paths([str(REPO / "presto_tpu_torch")])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_module_entry_point_exit_codes(tmp_path):
    clean = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.analysis.concurrency",
         "presto_tpu_torch"], cwd=REPO, capture_output=True, text=True)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    fixture = tmp_path / "bad.py"
    fixture.write_text(_SYNC_UNDER_LOCK.format(call="x.item()"))
    bad = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.analysis.concurrency",
         str(fixture)], cwd=REPO, capture_output=True, text=True)
    assert bad.returncode == 1 and LOCK_BLOCKING_HELD in bad.stdout


_SYNC_UNDER_LOCK = ("import threading\n"
                    "import torch\n"
                    "class C:\n"
                    "    def __init__(self):\n"
                    "        self._lock = threading.Lock()\n"
                    "    def f(self, x, ev):\n"
                    "        with self._lock:\n"
                    "            return {call}\n")


@pytest.mark.parametrize("call", [
    "x.item()", "x.cpu()", "torch.cuda.synchronize()", "ev.synchronize()"])
def test_torch_device_sync_under_lock_flagged(call):
    src = _SYNC_UNDER_LOCK.format(call=call)
    assert [f.code for f in check_source(src)] == [LOCK_BLOCKING_HELD]
    src = src.replace(call, f"{call}  # {PRAGMA_BLOCKING}")
    assert check_source(src) == []


def test_torch_device_sync_outside_lock_not_flagged():
    src = _SYNC_UNDER_LOCK.format(call="1").replace(
        "            return 1\n", "            y = 1\n        return x.item()\n")
    assert check_source(src) == []


def test_check_or_raise_routes_through_error_taxonomy(tmp_path):
    fixture = tmp_path / "bad.py"
    fixture.write_text(_SYNC_UNDER_LOCK.format(call="x.cpu()"))
    with pytest.raises(PlanValidationError):
        check_or_raise([str(fixture)])
    check_or_raise([str(REPO / "presto_tpu_torch")])


def test_codes_and_pragmas_equal_the_reference():
    assert ALL_CONCURRENCY_CODES == jconc.ALL_CONCURRENCY_CODES == (
        LOCK_UNGUARDED, LOCK_BLOCKING_HELD, LOCK_IN_CALLBACK, LOCK_ORDER)
    assert PRAGMA_BLOCKING == jconc.PRAGMA_BLOCKING
