"""The JAX package's rows for TPC-H Q1-Q22 at sf0.01, the golden file the
port's chip script holds its CUDA rows to
(presto_tpu_torch/benchmarks/tpch_sf001_rows.json).  It lives under
tests/ because the port may not import the reference.

    python tests/torch_tpch_golden.py      # rewrite the file

tests/test_torch_tpch_*.py hold the file equal to the live reference
rows, so it cannot go stale."""
import json
import os
import sys

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "presto_tpu_torch", "benchmarks", "tpch_sf001_rows.json")
SCHEMA = "sf0.01"


def entry(result) -> dict:
    """One query's golden entry from a QueryResult."""
    from presto_tpu_torch.benchmarks.rows import encode_value
    return {"columns": list(result.column_names),
            "rows": [[encode_value(v) for v in r] for r in result.rows]}


def load() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def write(path: str = GOLDEN_PATH) -> dict:
    """Run Q1-Q22 through the reference's LocalQueryRunner (its default
    config) and write their rows."""
    from presto_tpu.exec.runner import LocalQueryRunner
    from presto_tpu_torch.benchmarks.tpch_queries import ALL, ORDERED
    runner = LocalQueryRunner(SCHEMA)
    doc = {"schema": SCHEMA, "ordered": sorted(ORDERED),
           "queries": {str(q): entry(runner.execute(ALL[q]))
                       for q in sorted(ALL)}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
        f.write("\n")
    return doc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (the CPU platform, as the tests run)
    write()
