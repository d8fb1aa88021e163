"""The port's TPC-H driver (presto_tpu_torch/benchmarks/driver.py) with
--device cpu at sf0.01 over Q1 and Q6: one JSON record per query and a
summary, the row counts equal to the JAX package's driver on the same
queries; the suite runner's subprocess command; and the driver's default
device is the card."""
import json

from presto_tpu.benchmarks import driver as jdriver
from presto_tpu_torch.benchmarks import driver, suite_runner
from torch_threads import one_torch_thread  # noqa: F401


def _records(out: str):
    return [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]


def test_driver_on_the_cpu_equals_the_reference(capsys, tmp_path):
    path = tmp_path / "out.json"
    rc = driver.main(["--sf", "0.01", "--runs", "1", "--prewarm", "0",
                      "--queries", "1,6", "--device", "cpu",
                      "--json", str(path)])
    got = _records(capsys.readouterr().out)
    assert rc == 0
    assert jdriver.main(["--sf", "0.01", "--runs", "1", "--prewarm", "0",
                         "--queries", "1,6"]) == 0
    want = _records(capsys.readouterr().out)
    assert [r["query"] for r in got[:-1]] == ["q01", "q06"]
    assert [r["rows"] for r in got[:-1]] == [r["rows"] for r in want[:-1]]
    assert all(r["device"] == "cpu" and r["best_s"] > 0 for r in got[:-1])
    assert got[-1]["queries_ok"] == 2 and got[-1]["device"] == "cpu"
    assert json.loads(path.read_text())["summary"] == got[-1]


def test_driver_defaults_to_the_card(capsys):
    import argparse
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, argv=None):
        ns = real(self, argv)
        seen.update(vars(ns))
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = spy
    try:
        try:
            driver.main([])
        except SystemExit:
            pass
    finally:
        argparse.ArgumentParser.parse_args = real
    assert seen["device"] == "cuda"


def test_suite_runner_passes_the_device(monkeypatch, capsys):
    calls = []

    class Done:
        stdout = json.dumps({"query": "q01", "sf": 0.01, "best_s": 0.1,
                             "runs_s": [0.1], "rows": 4}) + "\n"
        stderr = ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return Done()
    monkeypatch.setattr(suite_runner.subprocess, "run", fake_run)
    assert suite_runner.main(["--sf", "0.01", "--device", "cpu"]) == 0
    assert len(calls) == 22
    assert calls[0][1:3] == ["-m", "presto_tpu_torch.benchmarks.driver"]
    assert calls[0][-2:] == ["--device", "cpu"]
