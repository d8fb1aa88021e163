"""The stage ring's plan (kernel #2, scan_kernel.ScanPlan.staging) on the
CPU, over the plans of Q6, Q1, J2 (direct), S1, span-f (span) and H1
(hash) that the port's runner builds at sf0.01:

- the decision is deterministic and does not depend on the query's
  literals;
- every per-row array the kernels read under a tile's full row mask is
  staged -- read off the generated single-mode source: the loads before
  the first step that narrows `live` --, the 1- and 2-byte arrays
  wherever they are read, and no 8-byte array first read after a
  narrowing step (Q6's l_extendedprice); J2 stages its probe key;
- single and double launches share the layout, the CTA count and the
  reservation of the launch's partials, and the ring's depth fills only
  the shared memory left at that CTA count;
- each generated double source stages exactly the decided arrays, sizes
  its argument struct to every word, carries the bulk-copy and mbarrier
  helpers and no cp.async chunk loop, and guards no stage with a CTA
  barrier;
- stage_ring_counts is a brute-force walk of the tiles over the staged
  arrays.

The kernels themselves compile and run only on the card
(chip_smoke.py); tests/test_torch_dma.py holds double mode's rows to the
reference's double-buffered Pallas kernel."""
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from presto_tpu_torch.benchmarks import join_queries as JQ
from presto_tpu_torch.benchmarks.grouped_queries import H1, S1
from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
from presto_tpu_torch.exec.kernels import codegen
from presto_tpu_torch.exec.kernels import grouped as gk
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401

SPAN_F = ("select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct, "
          "sum(cast(l_extendedprice as double)) as s, "
          "max(cast(l_discount as double)) as mx, count(*) as n "
          "from lineitem group by 1, 2, 3, 4")
Q6_OTHER = Q6.replace("date '1994-01-01'", "date '1995-03-01'").replace(
    "0.06", "0.07")
S1_OTHER = S1.replace("date '1998-09-02'", "date '1996-03-11'")
QUERIES = {"q6": (Q6, "scan_direct"), "q6_other": (Q6_OTHER, "scan_direct"),
           "q1": (Q1, "scan_direct"), "j2": (JQ.J2, "scan_direct"),
           "s1": (S1, "scan_span"), "s1_other": (S1_OTHER, "scan_span"),
           "span_f": (SPAN_F, "scan_span"), "h1": (H1, "scan_hash")}
CSRC = Path(sk.__file__).parent / "csrc"
CARD = SimpleNamespace(type="cuda")


@pytest.fixture(scope="module")
def calls():
    """{query: (wrapper, plan, columns, grid, br, joins, slots)} of its
    last scan kernel call."""
    wrappers = {"scan_direct": sk, "scan_span": gk, "scan_hash": gk}
    real = {k: getattr(m, k) for k, m in wrappers.items()}
    seen = []

    def recorder(name):
        def rec(*a, **kw):
            seen.append((name, a, kw))
            return real[name](*a, **kw)
        return rec
    for k, m in wrappers.items():
        setattr(m, k, recorder(k))
    # the resident store is process-global and reuses a column built
    # under a larger batch capacity; a 1M-row pad (an ExecutionConfig()
    # runner earlier in the process) leaves sf0.01's 1-byte columns plain,
    # so the plans are built over an empty store, at this runner's pad
    from presto_tpu_torch.storage import store as storage
    for st in list(storage._STORES.values()):
        st.clear()
    try:
        runner = LocalQueryRunner("sf0.01", device="cpu")
        out = {}
        for name, (sql, wrapper) in QUERIES.items():
            runner.execute(sql)
            w, a, kw = seen[-1]
            assert w == wrapper, (name, w)
            slots = a[5] if w == "scan_hash" else a[0].G
            out[name] = (w, a[0], a[1], a[2], a[3], kw.get("joins"), slots)
        return out
    finally:
        for k, m in wrappers.items():
            setattr(m, k, real[k])


def _staging(call):
    _w, plan, columns, _g, _br, _j, slots = call
    return plan.staging(columns, slots)


def _names(call, idx):
    return {call[1].names[c] for c in idx}


def _source(call, dma):
    w, plan, columns, _g, _br, joins, _s = call
    plan.dev.clear()
    make = sk.direct_kernel if w == "scan_direct" else gk.span_kernel
    return make(plan, columns, joins, dma)


def test_the_decision_is_deterministic_and_ignores_literals(calls):
    for name, call in calls.items():
        first = _staging(call)
        call[1].dev.clear()
        assert _staging(call) == first, name
        assert first.stages in range(sk.MIN_STAGES, sk.MAX_STAGES + 1)
    for a, b in (("q6", "q6_other"), ("s1", "s1_other")):
        first = _staging(calls[a])
        calls[b][1].dev.clear()
        assert _staging(calls[b]) == first, (a, b)
        assert _source(calls[a], "double").source == \
            _source(calls[b], "double").source, (a, b)


def _full_mask_loads(src, words):
    """Kernel columns the generated source loads before the first step
    that narrows `live` (a filter's `live &= ok`, an inner join's `live &=
    jhit`; the key check drops only rows off the grid)."""
    m = re.search(r"live &= (ok|jhit)\d+;", src)
    cut = m.start() if m else len(src)
    loads = re.findall(r"(?:load_rows|stage_rows|rle_rows)<[^>]+>"
                       r"\([^;]*?\ba\.w\[(\d+)\]", src[:cut])
    return {words[int(i)][1] for i in loads if words[int(i)][0] == "col0"}


@pytest.mark.parametrize("name", ["q6", "q1", "j2", "s1", "span_f"])
def test_arrays_read_under_the_full_mask_are_staged(calls, name):
    call = calls[name]
    plan, columns = call[1], call[2]
    st = _staging(call)
    kern = _source(call, "single")
    dense = {c for c in _full_mask_loads(kern.source, kern.words)
             if columns[c].kind in ("plain", "dict")}
    assert dense <= set(st.staged), name
    for c in st.staged:
        assert columns[c].kind in ("plain", "dict")
        if c not in dense:          # read only after a narrowing step
            assert columns[c].arrays[0].element_size() <= 2, \
                (name, plan.names[c])
    # every array the plan reads is staged, or is an RLE column, or a
    # 4- or 8-byte array first read after a narrowing step
    reads = sk.first_reads(plan.names, plan.step_programs, plan.joins,
                           plan.key_programs, plan.agg_programs, plan.specs)
    for c, narrowed in reads.items():
        if c not in st.staged:
            assert columns[c].kind == "rle" or (
                narrowed and columns[c].arrays[0].element_size() > 2), \
                (name, plan.names[c])


def test_the_slice_queries_stage_what_they_read_densely(calls):
    staged = {q: {n.rsplit("_", 1)[0] for n in _names(calls[q],
                                                      _staging(calls[q])
                                                      .staged)}
              for q in ("q6", "q1", "j2", "s1", "span_f", "h1")}
    # Q6: the filter's columns; l_extendedprice (int64) is read only for
    # the rows that pass it
    assert staged["q6"] == {"l_quantity", "l_discount", "l_shipdate"}
    assert "l_extendedprice" not in staged["q1"] | staged["h1"]
    # J2 reads its probe key for every row; its 1-byte aggregate inputs
    # after the semi step are staged too
    assert "l_suppkey" in staged["j2"]
    # H1: the filter's date and its 1-byte group keys
    assert staged["h1"] == {"l_shipdate", "l_quantity", "l_discount"}
    # span-f has no filter: every array is read under the full mask
    assert staged["span_f"] == {
        n.rsplit("_", 1)[0] for n in calls["span_f"][1].names}


def test_single_and_double_share_layout_ctas_and_reservation(
        calls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: SimpleNamespace(multi_processor_count=132))
    for name, call in calls.items():
        w, plan, columns, grid, br, joins, slots = call
        st = _staging(call)
        base, per_sm = plan.ring_room(slots)
        # the layout reserved the two-stage ring; the deeper ring fills
        # only the room left at the layout's CTA count
        assert plan.ring_reserve >= sk.min_ring_bytes(
            st.staged, sk.scan_shape(columns), plan.threads), name
        assert base + st.ring_bytes <= sk.MAX_SMEM_BYTES, name
        if st.stages > sk.MIN_STAGES:
            assert per_sm * (base + st.ring_bytes
                             + sk.SMEM_RESERVED_PER_CTA) <= sk.SMEM_PER_SM
        if w == "scan_hash":
            lay = plan.layout(slots)
            assert lay.ctas_per_sm == per_sm
            one = sk.launch_tensors(plan, columns, grid, torch.device("cpu"),
                                    joins, "single", 0, lay.table_bytes,
                                    slots)
            two = sk.launch_tensors(plan, columns, grid, torch.device("cpu"),
                                    joins, "double", 0, lay.table_bytes,
                                    slots)
            assert (one.stages, two.stages) == (1, st.stages), name
            # the ring, the stage table and the producer's state
            assert two.smem_bytes - one.smem_bytes == \
                st.ring_bytes + 8 * len(columns) + 128, name
            continue
        one, two = _source(call, "single"), _source(call, "double")
        assert one.ctas_per_sm == two.ctas_per_sm == per_sm, name
        assert two.staging == st and one.staging is None, name
        assert two.smem_bytes - one.smem_bytes == st.ring_bytes, name
        if w == "scan_span":
            assert one.layout == two.layout == plan.layout(plan.G), name
            # the reservation partial_bytes makes is the layout's, whatever
            # the mode
            _r, _s, n_ctas = gk._grid_shape(plan, len(grid), br, plan.G,
                                            CARD)
            lay = plan.layout(plan.G)
            assert gk.partial_bytes(plan, len(grid), br, plan.G, CARD) == \
                8 * n_ctas * plan.G * (plan.n_fold * lay.on_chip
                                       + plan.n_f * lay.f_tables), name
    # the slice's plans have room for more than two stages; J2's probe
    # keeps stages of one pass, which leave its table gathers the L1
    for name, call in calls.items():
        st = _staging(call)
        assert st.stages > sk.MIN_STAGES, name
        if name == "j2":
            assert st.passes == 1
        # a stage holds passes of one work item: P divides an item's
        item = sk.ROWS_PER_CTA if call[0] == "scan_direct" \
            else sk.GROUPED_SUBTILE_ROWS
        assert -(-item // (sk.ROWS_PER_THREAD * call[1].threads)) \
            % st.passes == 0, name


@pytest.mark.parametrize("name", ["q6", "q1", "j2", "s1", "span_f"])
def test_double_sources_stage_exactly_the_decided_arrays(calls, name):
    call = calls[name]
    st = _staging(call)
    one, two = _source(call, "single"), _source(call, "double")
    words = two.words
    src = two.source
    # one bulk copy per staged array in the fill, one staged load each
    copies = re.findall(r"ring_copy\(arr(\d+),", src)
    assert sorted(int(c) for c in copies) == sorted(st.staged)
    staged_loads = re.findall(r"stage_rows<[^>]+>\(stage \+ (\d+), "
                              r"a\.w\[(\d+)\]", src)
    assert sorted(words[int(w)][1] for _o, w in staged_loads) == \
        sorted(st.staged)
    for off, w in staged_loads:
        assert int(off) == st.offsets[words[int(w)][1]]
    # the argument struct holds every word
    size = int(re.search(r"struct Args \{ i64 w\[(\d+)\]; \};",
                         src).group(1))
    used = [int(i) for i in re.findall(r"\ba\.w\[(\d+)\]", src)]
    assert size == len(words) and max(used) < size
    # the bulk-copy ring on mbarriers, no cp.async chunk loop, and no CTA
    # barrier beyond the one that publishes the barriers' initialisation
    for helper in ("ring_fill(", "ring_init(", "mbar_wait(full",
                   "mbar_wait(empty", "mbar_arrive(empty", "ring_next("):
        assert helper in src, helper
    assert f"#define GS {st.stages}" in src
    assert "cp_async" not in src and "cp.async.cg" not in src
    assert src.count("__syncthreads") == \
        one.source.count("__syncthreads") + 1
    assert "ring_copy(" not in one.source and "mbar_" not in one.source


def test_the_headers_issue_bulk_copies_on_mbarriers():
    common = (CSRC / "scan_common.cuh").read_text()
    for ptx in ("cp.async.bulk.shared::cluster.global.mbarrier::"
                "complete_tx::bytes",
                "mbarrier.arrive.expect_tx.shared::cta.b64",
                "mbarrier.try_wait.parity.shared::cta.b64",
                "mbarrier.init.shared::cta.b64",
                "fence.mbarrier_init.release.cluster"):
        assert ptx in common, ptx
    for f in CSRC.iterdir():
        text = f.read_text()
        assert "cp.async.cg" not in text and "cp_async" not in text, f.name
    hash_src = (CSRC / "scan_grouped.cu").read_text()
    assert "ring_copy(" in hash_src and "mbar_wait(empty" in hash_src


def _walk(grid, br, rows_per_cta, n_sub, tile, n_ctas):
    """Per CTA, the tiles it computes, by walking its work items."""
    per_cta = [0] * n_ctas
    item = 0
    for _b, lo, hi in grid:
        for sub in range(n_sub):
            s_lo = lo + sub * rows_per_cta
            s_hi = min(hi, s_lo + rows_per_cta)
            per_cta[item % n_ctas] += (max(0, -(-(s_hi - s_lo) // tile))
                                       if s_hi > s_lo else 0)
            item += 1
    return per_cta


@pytest.mark.parametrize("n_ctas", [1, 5, 264])
def test_stage_ring_counts_walk_the_staged_arrays(calls, n_ctas):
    for name, call in calls.items():
        w, plan, columns, grid, br, _joins, slots = call
        st = _staging(call)
        if w == "scan_direct":
            rows_per_cta, n_sub = sk.direct_geometry(br)
        else:
            rows_per_cta = min(br, sk.GROUPED_SUBTILE_ROWS)
            n_sub = -(-br // rows_per_cta)
        tiles = _walk(grid, br, rows_per_cta, n_sub, st.rows, n_ctas)
        want = (len(st.staged) * sum(tiles),
                len(st.staged) * sum(max(0, t - 1) for t in tiles))
        assert sk.stage_ring_counts(st, grid, br, rows_per_cta, n_sub,
                                    n_ctas) == want, name
        assert want[0] > 0


@pytest.mark.parametrize("sql", [
    "select count(*), sum(l_extendedprice) from lineitem "
    "where l_orderkey < 3000",
    "select count(*) from lineitem where l_extendedprice is not null"],
    ids=["rle_filter", "is_not_null"])
def test_a_plan_that_stages_nothing_launches_unstaged(sql):
    """l_orderkey is run-length encoded and l_extendedprice is read only
    after the filter; a column only tested by IS NULL is never loaded (a
    resident column holds no NULLs).  Nothing is worth staging, so the
    double kernel is the single one and the ring meters nothing."""
    seen, real = [], sk.scan_direct

    def rec(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    sk.scan_direct = rec
    try:
        LocalQueryRunner("sf0.01", device="cpu").execute(sql)
    finally:
        sk.scan_direct = real
    (a, kw), = seen[-1:]
    plan, columns = a[0], a[1]
    st = plan.staging(columns)
    assert st.staged == () and st.stages == 0 and st.ring_bytes == 0
    assert plan.ring_reserve == 0
    one = sk.direct_kernel(plan, columns, None, "single")
    two = sk.direct_kernel(plan, columns, None, "double")
    assert two is one and two.staging is None
    assert sk.stage_ring_counts(st, a[2], a[3], *sk.direct_geometry(a[3]),
                                4) == (0, 0)
    before = dict(sk.STAGED_LAUNCHES)
    sk.count_launch("scan_direct", plan, two.staging is not None)
    assert sk.STAGED_LAUNCHES == before
    sk.LAUNCHES["scan_direct"] -= 1


def test_a_generated_ring_that_does_not_fit_raises(calls):
    call = calls["s1"]
    _w, plan, columns, _g, _br, joins, _s = call
    st = _staging(call)
    lay = plan.layout(plan.G)
    full = lay._replace(smem_bytes=sk.MAX_SMEM_BYTES - st.ring_bytes // 2)
    shape = codegen.column_shape(plan, columns, joins)
    with pytest.raises(NotImplementedError,
                       match=f"{st.ring_bytes}-byte stage ring"):
        codegen.generate_span(plan, shape, st, full)
