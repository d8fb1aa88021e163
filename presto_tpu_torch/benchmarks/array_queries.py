"""The array / UNNEST queries of the chip script's arrays phase
(benchmarks/arrays_run.py) and their array-free twins.

  U1  orders x unnest(array[o_custkey, o_shippriority, 7]): three rows per
      order, grouped by the element (about a million groups at SF10).
      Twin: the three plain aggregations, summed per x on the host.
  U2  lineitem x unnest(array[l_partkey, l_suppkey, l_linenumber]) WITH
      ORDINALITY, grouped by the ordinal.  Twin: count(*) and the three
      columns' sums over lineitem.
  U3  row_number() over the unnested (o_custkey, 2 o_orderkey [+ 1]) rows
      partitioned by o_custkey, the first 100 by (o_custkey, rn): the
      window kernel over unnested rows.  The elements are unique within a
      partition, so the order has no ties.  Twin: the same window over
      the UNION ALL of the two element columns.
  U4  one lineitem aggregation over the scalar array functions (element_at,
      contains, array_max, cardinality of a sequence), grouped by
      l_returnflag.  Twin: sum(l_suppkey), l_linenumber in (1, 3, 5),
      greatest(l_partkey, l_suppkey) and 4 * count(*).
  X1  an ARRAY column projected in a source fragment: through the
      distributed runner it crosses the gather exchange as an ArrayBlock.

No element is a `%` or `/` of a column: the reference and the port raise
"NULL array elements not supported" on an element whose column carries
a NULL mask."""

QUERIES = {
    "U1": "select x, count(*), sum(o_totalprice) from orders "
          "cross join unnest(array[o_custkey, o_shippriority, 7]) as u(x) "
          "group by x",
    "U2": "select i, count(*), sum(x) from lineitem "
          "cross join unnest(array[l_partkey, l_suppkey, l_linenumber]) "
          "with ordinality as u(x, i) group by i",
    "U3": "select o_custkey, x, rn from (select o_custkey, x, "
          "row_number() over (partition by o_custkey order by x) rn "
          "from orders cross join "
          "unnest(array[2 * o_orderkey, 2 * o_orderkey + 1]) as u(x)) "
          "order by o_custkey, rn limit 100",
    "U4": "select l_returnflag, "
          "sum(element_at(array[l_partkey, l_suppkey], 2)), "
          "sum(case when contains(array[1, 3, 5], l_linenumber) "
          "then 1 else 0 end), "
          "max(array_max(array[l_partkey, l_suppkey])), "
          "sum(cardinality(sequence(1, 4))) "
          "from lineitem group by l_returnflag",
    "X1": "select c_nationkey, a from (select c_nationkey, "
          "array[c_custkey, c_nationkey] a from customer) "
          "where c_nationkey < 2",
}
ORDERED = ("U3",)

TWINS = {
    # three plain aggregations, summed per x by check_twin (an outer
    # aggregation over their UNION ALL re-runs the union on each of its
    # hashed table's retries: 107 s at SF10 on the card)
    "U1": ("select o_custkey, count(*), sum(o_totalprice) from orders "
           "group by o_custkey",
           "select o_shippriority, count(*), sum(o_totalprice) from orders "
           "group by o_shippriority",
           "select 7, count(*), sum(o_totalprice) from orders"),
    "U2": "select count(*), sum(l_partkey), sum(l_suppkey), "
          "sum(l_linenumber) from lineitem",
    "U3": "select o_custkey, x, rn from (select o_custkey, x, "
          "row_number() over (partition by o_custkey order by x) rn "
          "from (select o_custkey, 2 * o_orderkey x from orders "
          "union all select o_custkey, 2 * o_orderkey + 1 from orders)) "
          "order by o_custkey, rn limit 100",
    "U4": "select l_returnflag, sum(l_suppkey), "
          "sum(case when l_linenumber in (1, 3, 5) then 1 else 0 end), "
          "max(greatest(l_partkey, l_suppkey)), 4 * count(*) "
          "from lineitem group by l_returnflag",
}


def run_twin(runner, name: str):
    """The twin's rows through `runner` (U1's three aggregations' rows
    concatenated)."""
    twin = TWINS[name]
    if isinstance(twin, tuple):
        return [row for sql in twin for row in runner.execute(sql).rows]
    return runner.execute(twin).rows


def check_twin(name: str, rows, twin_rows) -> None:
    """Raise AssertionError unless a query's rows equal its twin's (every
    value here is an integer or a decimal: exact)."""
    if name == "U1":
        # a million groups: compared as dicts, not sorted lists
        summed = {}
        for x, c, s in twin_rows:
            c0, s0 = summed.get(x, (0, 0))
            summed[x] = (c0 + c, s0 + s)
        got = {x: (c, s) for x, c, s in rows}
        assert len(got) == len(rows) and got == summed, \
            (name, len(got), len(summed))
        return
    if name == "U2":
        (cnt, s1, s2, s3), = twin_rows
        want = [[1, cnt, s1], [2, cnt, s2], [3, cnt, s3]]
        assert sorted(rows) == want, (name, sorted(rows), want)
        return
    if name in ORDERED:
        assert rows == twin_rows, (name, rows[:3], twin_rows[:3])
        return
    got, want = sorted(rows), sorted(twin_rows)
    assert got == want, (name, len(got), len(want), got[:3], want[:3])


def exchanged_arrays(subplan) -> list:
    """(RemoteSource node id, variable) of every ARRAY column a fragment
    of `subplan` reads from an exchange."""
    from ..common.types import ArrayType
    from ..spi import plan as P
    out = []
    for frag in subplan.all_fragments():
        for node in P.walk_plan(frag.root):
            if isinstance(node, P.RemoteSourceNode):
                out += [(node.id, v.name) for v in node.outputs
                        if isinstance(v.type, ArrayType)]
    return out
