"""The span kernel's generator (exec/kernels/codegen.py generate_span) on
the CPU: the CUDA source it emits for the span queries -- S1, S2, J3 (a
LEFT probe), span-f (float sums), span_minmax and the span expression
queries at sf0.01 -- is deterministic, does not depend on literal values,
holds no interpreter (the chain is straight-line code, as the direct
kernel's), decodes each column once per row, and was generated for the
one layout decision (ScanPlan.layout) that the launch geometry and the
reservation read, the same for single and double launches.  A missing
emitter raises and names its opcode.  The kernel itself compiles and runs
only on the card (chip_smoke.py); the span queries' rows through the
plain version stay equal to the reference's (tests/test_torch_grouped*.py,
tests/test_torch_join.py, tests/test_torch_expr_ops.py)."""
import re
from types import SimpleNamespace

import pytest
import torch

from presto_tpu_torch.benchmarks import expr_queries as EQ
from presto_tpu_torch.benchmarks import join_queries as JQ
from presto_tpu_torch.benchmarks.grouped_queries import S1, S2, SPAN_F_CTA
from presto_tpu_torch.exec.kernels import build, codegen
from presto_tpu_torch.exec.kernels import grouped as gk
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401

SPAN_F = ("select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct, "
          "sum(cast(l_extendedprice as double)) as s, "
          "max(cast(l_discount as double)) as mx, count(*) as n "
          "from lineitem group by 1, 2, 3, 4")
SPAN_MINMAX = (
    "select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct, "
    "sum(cast(l_extendedprice as double)) as s, min(l_quantity) as mn, "
    "max(cast(l_discount as double)) as mx, max(l_orderkey) as mo, "
    "count(l_tax) as c from lineitem group by 1, 2, 3, 4")
S1_OTHER = S1.replace("date '1998-09-02'", "date '1996-03-11'")
# an IN list: its constants are LIT instructions, not bound parameters
SPAN_IN = ("select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct, "
           "count(*) as n from lineitem where l_linenumber in (1, 2, 3) "
           "group by 1, 2, 3, 4")
SPAN_IN_OTHER = SPAN_IN.replace("(1, 2, 3)", "(2, 5, 7)")
QUERIES = {"s1": S1, "s1_other": S1_OTHER, "s2": S2, "j3": JQ.J3,
           "span_f": SPAN_F, "span_minmax": SPAN_MINMAX,
           "span_f_cta": SPAN_F_CTA,
           "span_in": SPAN_IN, "span_in_other": SPAN_IN_OTHER}
QUERIES.update({"x_" + k: v for k, v in EQ.QUERIES.items()})
CARD = SimpleNamespace(type="cuda")


@pytest.fixture(scope="module")
def calls():
    """{query: the (plan, columns, grid, br, joins) of its last scan_span
    call}."""
    seen, real = [], gk.scan_span

    def recording(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    gk.scan_span = recording
    try:
        runner = LocalQueryRunner("sf0.01", device="cpu")
        out = {}
        for name, sql in QUERIES.items():
            n0 = len(seen)
            runner.execute(sql)
            if len(seen) > n0:
                a, kw = seen[-1]
                out[name] = (a[0], a[1], a[2], a[3], kw.get("joins"))
        return out
    finally:
        gk.scan_span = real


def _kernel(call, dma="single"):
    plan, columns, _grid, _br, joins = call
    plan.dev.clear()
    return gk.span_kernel(plan, columns, joins, dma)


def test_the_span_queries_run_the_span_kernel(calls):
    assert {"s1", "s1_other", "s2", "j3", "span_f",
            "span_minmax", "x_span_case"} <= set(calls)
    assert calls["j3"][4] is not None
    assert calls["j3"][0].joins[0].step.is_left


@pytest.mark.parametrize("dma", ["single", "double"])
def test_source_is_deterministic(calls, dma):
    for name, call in calls.items():
        first = _kernel(call, dma).source
        assert _kernel(call, dma).source == first, name
        assert first.count("scan_span_gen(") == 1, name
        assert first.count("scan_span_reduce(") == 1, name
        # the stage ring's bulk copies, where the plan stages an array
        plan, columns = call[0], call[1]
        staged = bool(plan.staging(columns).stages)
        assert ("ring_copy(" in first) == (dma == "double" and staged), name
        assert "cp_async" not in first, name


@pytest.mark.parametrize("dma", ["single", "double"])
def test_the_argument_struct_holds_every_word(calls, dma):
    """A staged column no program reads (span_minmax's l_tax: its count
    equals __seen) still has its word inside the launch's struct."""
    for name, call in calls.items():
        kern = _kernel(call, dma)
        size = int(re.search(r"struct Args \{ i64 w\[(\d+)\]; \};",
                             kern.source).group(1))
        used = [int(i) for i in re.findall(r"\ba\.w\[(\d+)\]", kern.source)]
        assert size == len(kern.words) and max(used) < size, name


def test_literals_do_not_change_the_source(calls):
    a, b = _kernel(calls["s1"]), _kernel(calls["s1_other"])
    assert a.source == b.source
    assert build.gen_key(a.source) == build.gen_key(b.source)
    # a literal compiled into the plan travels in the launch's words
    kern = _kernel(calls["span_in"])
    other = _kernel(calls["span_in_other"])
    assert kern.source == other.source
    lits = [w for w in kern.words if w[0] == "lit"]
    assert [w[1] for w in lits] == [1, 2, 3]
    assert [w[1] for w in other.words if w[0] == "lit"] == [2, 5, 7]


def test_no_interpreter_in_the_source(calls):
    for name, call in calls.items():
        for dma in ("single", "double"):
            src = _kernel(call, dma).source
            for symbol in ("eval_prog", "interpret", "eval_ext", "Tile",
                           "run_steps", "probe_step"):
                assert not re.search(rf"\b{symbol}\b", src), (name, symbol)


@pytest.mark.parametrize("name", ["s1", "s2", "j3", "span_minmax"])
def test_each_column_is_decoded_once_per_row(calls, name):
    kern = _kernel(calls[name])
    plan = calls[name][0]
    for c, col in enumerate(plan.names):
        assert len(re.findall(rf"\bi64 c{c}\[RPT\];", kern.source)) <= 1, col
    loads = re.findall(r"(load_rows|stage_rows|rle_rows)<[^>]+>"
                       r"\([^;]*?\ba\.w\[(\d+)\]", kern.source)
    col0 = {i for i, w in enumerate(kern.words) if w[0] == "col0"}
    read = [int(i) for _f, i in loads if int(i) in col0]
    assert len(read) == len(set(read)) == len(col0)


def test_single_and_double_share_the_layout_and_the_reservation(
        calls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: SimpleNamespace(multi_processor_count=132))
    paths = {}
    for name, call in calls.items():
        plan, columns, grid, br, joins = call
        lay = plan.layout(plan.G)
        one, two = _kernel(call, "single"), _kernel(call, "double")
        assert one.layout == two.layout == lay, name
        assert one.ctas_per_sm == two.ctas_per_sm == lay.ctas_per_sm, name
        assert f"__launch_bounds__(GT, {lay.ctas_per_sm})" in one.source
        assert f"__launch_bounds__(GT, {lay.ctas_per_sm})" in two.source
        # what the launch runs is what try_grouped_scan_kernel reserves
        _rows, _sub, n_ctas = gk._grid_shape(plan, len(grid), br, plan.G,
                                             CARD)
        assert gk.partial_bytes(plan, len(grid), br, plan.G, CARD) == \
            8 * n_ctas * plan.G * (plan.n_fold * lay.on_chip
                                   + plan.n_f * lay.f_tables), name
        assert gk.stage_counts(plan, columns, grid, br, plan.G,
                               "single") == (0, 0)
        # the double launch's ring beside the tables: the generated
        # layout, within the kernel's shared memory; at least the two
        # stages the layout reserved
        ring = plan.staging(columns).ring_bytes
        assert two.smem_bytes - one.smem_bytes == ring, name
        assert ring >= plan.ring_reserve, name
        assert two.smem_bytes <= 227 * 1024
        paths[name] = (lay.on_chip, lay.warp_floats)
    # S1 and J3 keep their integer tables on chip, span-f its float
    # tables per warp, SPAN_F_CTA one float table per CTA; S2's 21504
    # slots take the device-memory path
    assert paths["s1"] == paths["j3"] == (True, False)
    assert paths["span_f"] == paths["span_minmax"] == (True, True)
    assert paths["span_f_cta"] == (True, False)
    assert calls["span_f_cta"][0].layout(5376).f_tables == 1
    assert paths["s2"] == (False, False)


def test_the_tail_folds_by_the_layout(calls):
    s1, s2 = _kernel(calls["s1"]).source, _kernel(calls["s2"]).source
    # on chip: per-row shared-memory folds, part_i once per CTA; no warp
    # peer sweep
    assert "shared_add64(&sm_i[" in s1 and "part_i[" in s1
    assert "__ballot_sync" not in s1 and "atomicAdd((u64*)&acc_i" not in s1
    # device memory: one global atomic a row, no on-chip table
    assert "atomicAdd((u64*)&acc_i[" in s2 and "shared_add64" not in s2
    # float rows: staged per row position, no float atomics
    f = _kernel(calls["span_f"]).source
    assert "warp_stage_float(" in f and "grouped_reduce(" in f
    assert not re.search(r"atomicAdd\(\(double", f)
    assert "apply_staged" not in f and "__syncthreads_or" not in f
    # one float table per CTA: every warp stages, the CTA applies in order
    cta = _kernel(calls["span_f_cta"]).source
    assert "apply_staged(" in cta and "__syncthreads_or(wany)" in cta


def test_a_missing_emitter_raises_naming_the_opcode(calls, monkeypatch):
    monkeypatch.delitem(codegen.EMITTERS, "IF")
    with pytest.raises(NotImplementedError, match="IF"):
        _kernel(calls["x_span_case"])
