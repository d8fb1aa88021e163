"""Fanout-1 joins and semi joins on the CPU: the join slice's queries (J1-J3)
and the reference's join shapes through the port's
LocalQueryRunner(device="cpu") -- the scan kernels' plain versions with
kernel #5's plain probe -- return exactly the reference package's rows,
with the Pallas kernel and its in-kernel probe engaged on the reference
side (interpret mode).  Both sides run exactly one kernel program and
decline nothing; a recording wrapper shows which wrapper ran, with which
table kinds and forms.  The build tables FusedChain.prep makes match the
reference's bit for bit."""
import numpy as np
import pytest
import torch

from presto_tpu.exec import fused as jfused
from presto_tpu.exec.pipeline import PlanCompiler as JCompiler
from presto_tpu.exec.pipeline import TaskContext as JContext
from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu.spi import plan as JP
from presto_tpu_torch.benchmarks import join_queries as JQ
from presto_tpu_torch.exec import fused as tfused
from presto_tpu_torch.exec.kernels import grouped as gk
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.pipeline import PlanCompiler as TCompiler
from presto_tpu_torch.exec.pipeline import TaskContext as TContext
from presto_tpu_torch.exec.pipeline import tuned_config as ttuned
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.spi import plan as TP
from torch_threads import one_torch_thread  # noqa: F401

# a semi join against a sparse key set: a hash-sorted unique table at
# sf0.01 (J2's build is a DirectTable there)
SEMI_UNIQUE = ("select l_returnflag, count(*) as n, sum(l_quantity) as q "
               "from lineitem where l_partkey in (select ps_partkey from "
               "partsupp where ps_availqty < 100) group by l_returnflag")


def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


def _declined(res):
    return [k for k in res.runtime_stats if k.startswith("kernelDeclined")]


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


@pytest.fixture
def recorded(monkeypatch):
    """[(wrapper, ((table, form), ...))] of every scan wrapper call."""
    seen = []
    for mod, name in ((sk, "scan_direct"), (gk, "scan_span"),
                      (gk, "scan_hash")):
        real = getattr(mod, name)

        def recording(plan, *a, _real=real, _name=name, **kw):
            seen.append((_name, tuple(
                (jp.step.table, "semi" if jp.step.kind == "semi"
                 else "left" if jp.step.is_left else "inner")
                for jp in plan.joins)))
            return _real(plan, *a, **kw)
        monkeypatch.setattr(mod, name, recording)
    return seen


D_IN, D_LEFT, D_SEMI = ("direct", "inner"), ("direct", "left"), \
    ("direct", "semi")
CASES = [
    ("j1", JQ.J1, True, "scan_hash", (D_IN,)),
    ("j2", JQ.J2, True, "scan_direct", (D_SEMI,)),
    ("j3", JQ.J3, False, "scan_span", (D_LEFT,)),
    ("j3_suppkey", JQ.J3_SUPPKEY, False, "scan_span", (D_LEFT,)),
    ("q3_shape", JQ.Q3_SHAPE, False, "scan_hash", (D_IN,)),
    ("q18_shape", JQ.Q18_SHAPE, False, "scan_hash", (D_IN,)),
    ("semi", JQ.SEMI, False, "scan_direct", (D_SEMI,)),
    ("semi_unique", SEMI_UNIQUE, False, "scan_direct",
     (("unique", "semi"),)),
    ("multi_probe", JQ.MULTI_PROBE, False, "scan_direct", (D_IN, D_IN)),
    ("partsupp", JQ.PARTSUPP, False, "scan_direct", (("unique", "inner"),)),
]


@pytest.mark.parametrize("name,sql,ordered,wrapper,probes", CASES,
                         ids=[c[0] for c in CASES])
def test_join_rows_equal_reference(ref, port, recorded, name, sql, ordered,
                                   wrapper, probes):
    exp = ref.execute(sql)
    got = port.execute(sql)
    _assert_rows_equal(got, exp, ordered=ordered)
    assert got.column_names == exp.column_names
    assert got.rows, name
    assert _programs(got) == 1 and _programs(exp) == 1
    assert not _declined(got) and not _declined(exp)
    assert recorded and set(recorded) == {(wrapper, probes)}, recorded


def test_cases_cover_every_table_and_form():
    kinds = {p for c in CASES for p in c[4]}
    assert {t for t, _f in kinds} == {"direct", "unique"}
    assert {f for _t, f in kinds} == {"inner", "left", "semi"}
    assert any(len(c[4]) == 2 for c in CASES)        # a two-probe chain


def test_left_join_count_is_not_count_star(port):
    """A LEFT join's gathered column is NULL on a miss, so count(s_acctbal)
    counts the matched rows only: the plan must not copy it from __seen,
    and the rows must show misses."""
    res = port.execute(JQ.J3)
    hits = [r[4] for r in res.rows]
    n = [r[6] for r in res.rows]
    assert all(h <= c for h, c in zip(hits, n)) and sum(hits) < sum(n)
    assert sum(hits) > 0.8 * sum(n)


def test_wrappers_on_cpu_count_no_launch(port):
    before = dict(sk.LAUNCHES), dict(sk.JOIN_LAUNCHES)
    for sql in (JQ.J1, JQ.J2, JQ.J3):
        port.execute(sql)
    assert (sk.LAUNCHES, sk.JOIN_LAUNCHES) == before


def _agg_source(root, P):
    nd = root
    while not isinstance(nd, P.AggregationNode):
        nd = nd.sources[0]
    return nd.source


def _tables(aux):
    """Each probe step's table arrays as numpy, by name."""
    out = []
    for ent in aux[1:]:
        tbl, bhn = ent if isinstance(ent, tuple) else (ent, None)
        arrays = {"bhn": bhn}
        for f in ("slots", "base", "keyhash_sorted", "perm", "run_len",
                  "valid_count"):
            if hasattr(tbl, f):
                v = getattr(tbl, f)
                v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                arrays[f] = v.reshape(-1)
        for n, c in tbl.columns.items():
            v = c.values
            arrays["col:" + n] = np.asarray(
                v.numpy() if isinstance(v, torch.Tensor) else v)
        out.append((type(tbl).__name__, arrays))
    return out


@pytest.mark.parametrize("sql", [JQ.J2, JQ.J3, JQ.MULTI_PROBE, JQ.PARTSUPP,
                                 SEMI_UNIQUE],
                         ids=["j2", "j3", "multi_probe", "partsupp",
                              "semi_unique"])
def test_prep_tables_match_reference(ref, port, sql):
    """FusedChain.prep's build tables (build_lookup: materialize, compact,
    drop NULL keys, DirectTable or BuildTable) equal the reference's."""
    jchain = jfused.assemble_chain(
        JCompiler(JContext(config=jtuned(scan_kernel="pallas"))),
        _agg_source(ref.plan(sql), JP))
    tchain = tfused.assemble_chain(
        TCompiler(TContext(config=ttuned(), device=torch.device("cpu"))),
        _agg_source(port.plan(sql), TP))
    jaux, jexp, _ = jchain.prep()
    taux, texp, _ = tchain.prep()
    assert texp == tuple(jexp)
    want, got = _tables(jaux), _tables(taux)
    assert [k for k, _a in got] == [k for k, _a in want]
    for (_k, g), (_k2, w) in zip(got, want):
        assert g.keys() == w.keys()
        assert bool(g.pop("bhn") or False) == bool(w.pop("bhn") or False)
        for f in g:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
