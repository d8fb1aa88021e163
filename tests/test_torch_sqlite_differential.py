"""The port against SQLite (presto_tpu_torch/connectors/sqlite_backend.py,
a host copy of the JAX package's): the queries of
tests/test_sqlite_differential.py (held as data in
presto_tpu_torch/benchmarks/sqlite_queries.py, equal to the reference
test's) through the port on the CPU, rows equal to sqlite's over the same
generated data; the verifier with sqlite as the control over every query
(both results normalized to one form) all MATCH; and the exported sqlite
tables equal the JAX package's export row for row."""
import pytest

import test_sqlite_differential as ref_test
from presto_tpu_torch import verifier as V
from presto_tpu_torch.benchmarks import sqlite_queries as SQ
from presto_tpu_torch.connectors.sqlite_backend import SqliteRunner
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def engines():
    engine = LocalQueryRunner(f"sf{SQ.SF}", device="cpu",
                              config=ExecutionConfig(
                                  batch_rows=1 << 14,
                                  join_out_capacity=1 << 16))
    return engine, SqliteRunner(SQ.SF)


def test_queries_equal_the_reference_test():
    assert SQ.QUERIES == ref_test.QUERIES and SQ.SF == ref_test.SF
    for name, sql in SQ.QUERIES.items():
        for dialect in ("engine", "sqlite"):
            assert SQ.render(sql, dialect) == ref_test.render(sql, dialect)


@pytest.mark.parametrize("name", sorted(SQ.QUERIES))
def test_cross_engine(engines, name):
    engine, lite = engines
    got = engine.execute(SQ.render(SQ.QUERIES[name], "engine"))
    exp = lite.execute(SQ.render(SQ.QUERIES[name], "sqlite"))
    grows = sorted(([SQ.date_to_days(v) for v in r] for r in got.rows),
                   key=repr)
    erows = sorted(exp.rows, key=repr)
    assert len(grows) == len(erows)
    for gr, er in zip(grows, erows):
        for j, (a, b) in enumerate(zip(gr, er)):
            assert SQ.num_eq(a, b), (name, j, a, b, gr, er)


def test_verifier_with_sqlite_as_control(engines):
    engine, lite = engines
    names = sorted(SQ.QUERIES)
    eng = {n: SQ.render(SQ.QUERIES[n], "engine") for n in names}
    lit = {eng[n]: SQ.render(SQ.QUERIES[n], "sqlite") for n in names}
    types = {eng[n]: [v.type for v in engine.plan(eng[n]).outputs]
             for n in names}
    res = V.verify(lambda s: SQ.normalize(lite.execute(lit[s]), types[s]),
                   lambda s: SQ.normalize(engine.execute(s), types[s]),
                   [eng[n] for n in names])
    assert [r.status for r in res] == [V.MATCH] * len(names), \
        [(n, r.status, r.detail) for n, r in zip(names, res)
         if r.status != V.MATCH]


def test_verifier_detects_a_wrong_engine(engines):
    engine, lite = engines
    sql = SQ.render(SQ.QUERIES["in_subquery"], "engine")
    bad = sql.replace("nationkey = 5", "nationkey = 6")
    res = V.verify(lambda s: lite.execute(SQ.render(
        SQ.QUERIES["in_subquery"], "sqlite")), lambda s: engine.execute(bad),
        [sql])
    assert res[0].status == V.MISMATCH


@pytest.mark.parametrize("table", ["nation", "customer", "orders"])
def test_export_equals_the_reference(engines, table):
    from presto_tpu.connectors.sqlite_backend import SqliteRunner as JLite
    _, lite = engines
    jlite = JLite(SQ.SF, tables=[table])
    sql = f"select * from {table} order by 1, 2"
    assert lite.execute(sql).rows == jlite.execute(sql).rows
