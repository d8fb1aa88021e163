"""The port's numpy oracle (presto_tpu_torch/exec/reference.py) against the
JAX package's (presto_tpu/exec/reference.py): the same rows, exactly, on
TPC-H Q1-Q22 at sf0.01 and on the port's query banks
(presto_tpu_torch/benchmarks/*_queries.py) at sf0.001 (the two oracles'
row-at-a-time windows and joins over sf0.01 took minutes), each
statement planned by its own package; and the runner surface
(execute_reference, assert_same_as_reference,
last_reference_operator_stats) as the reference's."""
import pytest

from presto_tpu_torch.benchmarks import array_queries as AQ
from presto_tpu_torch.benchmarks import expr_queries as EQ
from presto_tpu_torch.benchmarks import function_queries as FQ
from presto_tpu_torch.benchmarks import grouped_queries as GQ
from presto_tpu_torch.benchmarks import join_queries as JQ
from presto_tpu_torch.benchmarks import tpcds_queries as DQ
from presto_tpu_torch.benchmarks import window_queries as WQ
from presto_tpu_torch.benchmarks.tpch_queries import queries_for_sf
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

SCHEMA = "sf0.01"
BANK_SCHEMA = "sf0.001"


def _bank():
    """name -> (sql, catalog, schema)."""
    out = {f"tpch_q{q:02d}": (sql, "tpch", SCHEMA)
           for q, sql in queries_for_sf(0.01).items()}
    for mod, names in ((GQ, ("S1", "H1", "H2", "S2", "SPAN_F",
                             "SPAN_F_CTA")),
                       (JQ, ("J1", "J2", "J2_NOPROBE", "J3", "J3_SUPPKEY",
                             "Q3_SHAPE", "Q18_SHAPE", "SEMI", "SEMI_UNIQUE",
                             "MULTI_PROBE", "PARTSUPP")),
                       (WQ, ("W1", "W2", "W3", "W1_LAG", "W_GLOBAL",
                             "W_SINGLE_ROW"))):
        short = mod.__name__.rsplit(".", 1)[-1].split("_")[0]
        out.update({f"{short}_{n}": (getattr(mod, n), "tpch", BANK_SCHEMA)
                    for n in names})
    for bank, d in (("window_kernel", WQ.KERNEL_SHAPES),
                    ("window_shape", WQ.SHAPES), ("expr", EQ.QUERIES),
                    ("array", AQ.QUERIES)):
        out.update({f"{bank}_{n}": (sql, "tpch", BANK_SCHEMA)
                    for n, sql in d.items()})
    out.update({f"function_{i:02d}": (sql, "tpch", BANK_SCHEMA)
                for i, sql in enumerate(FQ.ALL)})
    # sign() of sf0.001's customer.acctbal column: both oracles raise
    # (numpy's boolean subtract), so this statement runs at sf0.01
    out["function_07"] = (FQ.ALL[7], "tpch", SCHEMA)
    out.update({f"tpcds_{n}": (sql, "tpcds", BANK_SCHEMA)
                for n, sql in {**DQ.QUERIES, **DQ.SHAPES}.items()})
    return out


BANK = _bank()


@pytest.fixture(scope="module")
def runners():
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    out = {}

    def get(cat, schema=SCHEMA):
        if (cat, schema) not in out:
            out[cat, schema] = (
                LocalQueryRunner(schema, catalog=cat, device="cpu"),
                JRunner(schema, catalog=cat))
        return out[cat, schema]
    return get


def test_bank_size():
    assert len(BANK) == 175


@pytest.mark.parametrize("name", sorted(BANK))
def test_oracle_rows_equal_the_reference(runners, name):
    sql, cat, schema = BANK[name]
    port, ref = runners(cat, schema)
    got, want = port.execute_reference(sql), ref.execute_reference(sql)
    assert list(got.column_names) == list(want.column_names)
    assert [str(t) for t in got.column_types] == \
        [str(t) for t in want.column_types]
    assert_rows_close(got, want, ordered=True, rtol=0.0)


def test_runner_surface(runners):
    port, ref = runners("tpch")
    sql = queries_for_sf(0.01)[3]
    got = port.assert_same_as_reference(sql, ordered=True)
    ref.execute_reference(sql)
    stats, jstats = (port.last_reference_operator_stats,
                     ref.last_reference_operator_stats)
    assert sorted(stats) == sorted(jstats)
    for nid, rec in stats.items():
        assert rec["rows"] == jstats[nid]["rows"], nid
        assert rec["operatorType"] == jstats[nid]["operatorType"], nid
    assert len(got.rows) == 10
    with pytest.raises(AssertionError, match="value mismatch"):
        from presto_tpu_torch.exec.runner import _assert_rows_equal
        bad = port.execute("select count(*) + 1 from nation")
        _assert_rows_equal(bad, port.execute_reference(
            "select count(*) from nation"), True)
