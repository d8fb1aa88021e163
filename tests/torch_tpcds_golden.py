"""The JAX package's rows for the TPC-DS bank at sf0.01
(presto_tpu_torch/benchmarks/tpcds_queries.py `bank()`: the 21-query
conformance bank, the shape queries, Q95 in both windows and the three
Q95 cores), the golden file the port's chip script holds its CUDA rows
to (presto_tpu_torch/benchmarks/tpcds_sf001_rows.json).  It lives under
tests/ because the port may not import the reference.

    python tests/torch_tpcds_golden.py      # rewrite the file

tests/test_torch_tpcds_queries.py holds the file equal to the live
reference rows, so it cannot go stale."""
import json
import os
import sys

from torch_tpch_golden import entry

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "presto_tpu_torch", "benchmarks", "tpcds_sf001_rows.json")
SCHEMA = "sf0.01"


def load() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def reference_runners() -> dict:
    """The reference's LocalQueryRunner for each of the bank's configs."""
    from presto_tpu.exec.pipeline import ExecutionConfig
    from presto_tpu.exec.runner import LocalQueryRunner
    from presto_tpu_torch.benchmarks.tpcds_queries import BANK_CONFIG
    return {"bank": LocalQueryRunner(SCHEMA, catalog="tpcds",
                                     config=ExecutionConfig(**BANK_CONFIG)),
            "default": LocalQueryRunner(SCHEMA, catalog="tpcds")}


def write(path: str = GOLDEN_PATH) -> dict:
    """Run the bank through the reference and write its rows."""
    from presto_tpu_torch.benchmarks.tpcds_queries import bank
    runners = reference_runners()
    queries = bank()
    doc = {"schema": SCHEMA,
           "ordered": sorted(n for n, (_s, _c, o) in queries.items() if o),
           "queries": {n: entry(runners[c].execute(sql))
                       for n, (sql, c, _o) in sorted(queries.items())}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
        f.write("\n")
    return doc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (the CPU platform, as the tests run)
    write()
