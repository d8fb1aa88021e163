"""The direct kernel's generator (exec/kernels/codegen.py) on the CPU: the
CUDA source it emits for the slice's chains -- TPC-H Q1 and Q6, the semi
join J2 and the expression queries -- is deterministic, does not depend on
literal values (they travel in the launch's words), decodes each column
once per row, has an emitter for every opcode and names the opcode it
lacks.  The kernel itself compiles and runs only on the card
(chip_smoke.py); the plans here are the ones the port's CPU runner builds,
whose rows tests/test_torch_runner.py and tests/test_torch_expr_ops.py
hold to the reference package."""
import re

import pytest

from presto_tpu_torch.benchmarks import expr_queries as EQ
from presto_tpu_torch.benchmarks import join_queries as JQ
from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
from presto_tpu_torch.exec import lowering
from presto_tpu_torch.exec.kernels import build, codegen
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401

Q6_OTHER = Q6.replace("date '1994-01-01'", "date '1995-03-01'")
QUERIES = {"q6": Q6, "q1": Q1, "j2": JQ.J2, "q6_other": Q6_OTHER}
QUERIES.update({"x_" + k: v for k, v in EQ.QUERIES.items()})


@pytest.fixture(scope="module")
def calls():
    """{query: the (plan, columns, joins) of its last scan_direct call}."""
    seen, real = [], sk.scan_direct

    def recording(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    sk.scan_direct = recording
    try:
        runner = LocalQueryRunner("sf0.01", device="cpu")
        out = {}
        for name, sql in QUERIES.items():
            n0 = len(seen)
            runner.execute(sql)
            if len(seen) > n0:
                a, kw = seen[-1]
                out[name] = (a[0], a[1], kw.get("joins"))
        return out
    finally:
        sk.scan_direct = real


def _source(call, dma="single"):
    plan, columns, joins = call
    plan.dev.clear()
    return sk.direct_kernel(plan, columns, joins, dma).source


def test_the_slice_runs_the_direct_kernel(calls):
    assert {"q6", "q1", "j2", "q6_other"} <= set(calls)
    assert len([k for k in calls if k.startswith("x_")]) >= 5


@pytest.mark.parametrize("dma", ["single", "double"])
def test_source_is_deterministic(calls, dma):
    for name, call in calls.items():
        first = _source(call, dma)
        assert _source(call, dma) == first, name
        assert first.count("scan_gen(") == 1 and "scan_gen_reduce(" in first
        # the stage ring's bulk copies, where the plan stages an array
        plan, columns, _joins = call
        staged = bool(plan.staging(columns).stages)
        assert ("ring_copy(" in first) == (dma == "double" and staged), name
        assert "cp_async" not in first, name


def test_literals_do_not_change_the_source(calls):
    a, b = calls["q6"], calls["q6_other"]
    assert _source(a) == _source(b)
    assert build.gen_key(_source(a)) == build.gen_key(_source(b))
    # a literal compiled into the plan travels in the launch's words
    plan, columns, joins = calls["x_in_list"]
    plan.dev.clear()
    kern = sk.direct_kernel(plan, columns, joins)
    lits = [w for w in kern.words if w[0] == "lit"]
    assert lits
    for _kind, value in lits:
        assert codegen._hex(value) not in kern.source


def test_q1_decodes_each_column_once_per_row(calls):
    src = _source(calls["q1"])
    plan = calls["q1"][0]
    for c, name in enumerate(plan.names):
        assert len(re.findall(rf"\bi64 c{c}\[RPT\];", src)) == 1, name
    loads = re.findall(r"(load_rows|stage_rows|rle_rows)<[^>]+>"
                       r"\([^;]*?\ba\.w\[(\d+)\]", src)
    words = sk.direct_kernel(*calls["q1"]).words
    col0 = {i for i, w in enumerate(words) if w[0] == "col0"}
    read = [int(i) for _f, i in loads if int(i) in col0]
    assert len(read) == len(set(read)) == len(col0)


def test_every_opcode_has_an_emitter():
    # the opcodes the kernels run; the dictionary folds and the numeric
    # forms after them are the torch interpreter's alone
    assert set(codegen.EMITTERS) == {lowering.OPS[op]
                                     for op in lowering.KERNEL_OPS}


def test_a_missing_emitter_raises_naming_the_opcode(calls, monkeypatch):
    monkeypatch.delitem(codegen.EMITTERS, "MUL_I")
    with pytest.raises(NotImplementedError, match="MUL_I"):
        _source(calls["q6"])


def test_partials_stay_in_registers_where_they_fit(calls):
    q6 = sk.direct_kernel(*calls["q6"])
    q1 = sk.direct_kernel(*calls["q1"])
    assert q6.registers and "__ballot_sync" not in q6.source
    # Q1: 6 groups x 8 folded rows is past REG_PARTIALS: one sweep per pass
    assert calls["q1"][0].G * q1.n_fold > codegen.REG_PARTIALS
    assert not q1.registers and q1.source.count("__ballot_sync") == 1
    for kern in (q6, q1):
        assert kern.ctas_per_sm >= 1
        assert "atomicAdd((u64*)&sm_i" in kern.source   # integer folds only
    # single and double launch the same CTAs: the same float order
    for name in ("q6", "q1", "x_cast_double_div"):
        one = sk.direct_kernel(*calls[name], "single")
        two = sk.direct_kernel(*calls[name], "double")
        assert one.ctas_per_sm == two.ctas_per_sm, name

