"""The PyTorch port stands alone: no file of presto_tpu_torch/ or
chip_smoke.py imports JAX or the presto_tpu reference package, running a
query loads neither, and the runner never moves to the CPU on its own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "presto_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "presto_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _absolute_imports(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


def test_relative_imports_stay_inside_the_port():
    """A relative import can never climb out of presto_tpu_torch/."""
    for path in _port_files()[:-1]:
        depth = len(path.relative_to(ROOT / "presto_tpu_torch").parts)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth, (path, node.lineno)


def test_query_runs_without_loading_jax():
    code = (
        "import sys\n"
        "from presto_tpu_torch.benchmarks.tpch_queries import Q6\n"
        "from presto_tpu_torch.exec.runner import LocalQueryRunner\n"
        "res = LocalQueryRunner('sf0.01', device='cpu').execute(Q6)\n"
        "assert res.rows and res.rows[0][0] is not None, res.rows\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'presto_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_default_device_without_cuda_raises(monkeypatch):
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalQueryRunner()


def test_runner_has_its_own_plan_cache():
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    from presto_tpu_torch.serving import GLOBAL_PLAN_CACHE
    a = LocalQueryRunner(device="cpu")
    b = LocalQueryRunner(device="cpu")
    assert a.plan_cache is not b.plan_cache
    assert a.plan_cache is not GLOBAL_PLAN_CACHE


def test_the_scheduler_slice_is_scanned():
    """The distributed scheduler's modules are among the scanned files."""
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for rel in ("presto_tpu_torch/parallel/__init__.py",
                "presto_tpu_torch/parallel/fabric.py",
                "presto_tpu_torch/parallel/mesh.py",
                "presto_tpu_torch/exec/scheduler.py",
                "presto_tpu_torch/exec/adaptive.py",
                "presto_tpu_torch/benchmarks/distributed_run.py"):
        assert rel in scanned, rel


def test_distributed_query_runs_without_loading_jax():
    code = (
        "import sys\n"
        "from presto_tpu_torch.benchmarks.tpch_queries import Q1\n"
        "from presto_tpu_torch.exec.runner import DistributedQueryRunner\n"
        "res = DistributedQueryRunner('sf0.01', n_tasks=2, "
        "device='cpu').execute(Q1)\n"
        "assert len(res.rows) == 4, res.rows\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'presto_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
