"""Fanout-1 join and semi-join queries over lineitem: the join slice's
queries, run by chip_smoke.py on the card and held against the reference
package by tests/test_torch_join*.py.  Each runs as ONE scan kernel launch
with the probe inside it (kernel #5).

  J1  revenue by supplier nation over one ship year (the supplier half of
      TPC-H Q5): hash slots keyed by the gathered s_nationkey, an INNER
      probe of the supplier DirectTable.
  J2  lineitem by status, shipped by one nation's suppliers: direct slots
      (G = 6) behind a semi-join marker.  At SF10 the build (about 4 000
      keys over a span of 100 000) is a hash-sorted unique table; at
      SF0.01 the 1024-slot floor makes it a DirectTable.
  J2_NOPROBE  J2's columns and aggregation with no semi step (l_suppkey
      read by a filter every row passes): J2 minus J2_NOPROBE is the
      probe's device time.
  J3  supplier balances by Q1's dimensions: span slots (G = 168) behind a
      LEFT probe of the positive-balance suppliers (about 9 % of rows are
      null-extended).  count(s_acctbal) counts the matched rows only.
  J3_SUPPKEY  J3 with count(s_suppkey): it gathers a second 8-byte build
      column, so at SF10 (a 262 144-row build batch) its operands pass the
      4 MiB cap and it declines with kernelDeclinedJoinBuildSize in both
      packages; at SF0.01 it runs in the kernel.

The reference's join shapes (tests/test_join_kernel.py):

  Q3_SHAPE, Q18_SHAPE  lineitem join orders, grouped by order key (hash).
  SEMI        an IN-subquery over orders (a semi step).
  SEMI_UNIQUE an IN-subquery against a sparse key set: a hash-sorted
              unique table from sf0.01 up.
  MULTI_PROBE lineitem -> orders -> customer: two probes in one launch.
  PARTSUPP    a two-column unique probe on (partkey, suppkey).
  join_fuzz_sql(seed)  the reference's randomized lineitem join orders
              queries.
"""
import numpy as np

J1 = """
select s_nationkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       count(*) as n
from lineitem, supplier
where l_suppkey = s_suppkey
  and l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
group by s_nationkey
order by s_nationkey
"""

J2 = """
select l_returnflag, l_linestatus, sum(l_quantity) as q, count(*) as n
from lineitem
where l_suppkey in (select s_suppkey from supplier where s_nationkey = 7)
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

J2_NOPROBE = """
select l_returnflag, l_linestatus, sum(l_quantity) as q, count(*) as n
from lineitem
where l_suppkey >= 0
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

J3 = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       count(s_acctbal) as hits, sum(s_acctbal) as bal, count(*) as n
from lineitem left join
     (select s_suppkey, s_acctbal from supplier where s_acctbal > 0) s
     on l_suppkey = s_suppkey
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
"""

J3_SUPPKEY = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       count(s_suppkey) as hits, sum(s_acctbal) as bal, count(*) as n
from lineitem left join
     (select s_suppkey, s_acctbal from supplier where s_acctbal > 0) s
     on l_suppkey = s_suppkey
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
"""

Q3_SHAPE = """
select o_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       count(*) as cnt
from lineitem, orders
where l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by o_orderkey
"""

Q18_SHAPE = """
select l_orderkey, max(o_totalprice) as price, sum(l_quantity) as qty
from lineitem, orders
where l_orderkey = o_orderkey
group by l_orderkey
"""

SEMI = ("select count(*) from lineitem "
        "where l_orderkey in (select o_orderkey from orders "
        "where o_orderdate < date '1995-01-01')")

SEMI_UNIQUE = ("select l_returnflag, count(*) as n, sum(l_quantity) as q "
               "from lineitem where l_partkey in (select ps_partkey from "
               "partsupp where ps_availqty < 100) group by l_returnflag")

MULTI_PROBE = ("select count(*), sum(l_quantity) from lineitem, orders, "
               "customer where l_orderkey = o_orderkey "
               "and o_custkey = c_custkey and c_nationkey < 10")

PARTSUPP = ("select count(*), sum(ps_supplycost) from lineitem, partsupp "
            "where l_partkey = ps_partkey and l_suppkey = ps_suppkey")

_JOIN_AGGS = ["count(*)", "sum(l_quantity)", "sum(l_extendedprice)",
              "max(o_totalprice)", "min(l_quantity)", "avg(l_discount)"]


def join_fuzz_sql(seed: int) -> str:
    """The reference's randomized lineitem join orders query for `seed`
    (tests/test_join_kernel.py _join_fuzz_sql)."""
    rng = np.random.default_rng(seed)
    conj = ["l_orderkey = o_orderkey",
            f"l_quantity < {int(rng.integers(10, 45))}"]
    if rng.integers(2):
        y = int(rng.integers(1992, 1998))
        conj.append(f"l_shipdate >= date '{y}-01-01'")
    if rng.integers(2):
        y = int(rng.integers(1993, 1998))
        conj.append(f"o_orderdate < date '{y}-06-01'")
    if rng.integers(2):
        conj.append(f"l_orderkey < {int(rng.integers(1000, 30_000))}")
    n_aggs = int(rng.integers(2, 4))
    aggs = [_JOIN_AGGS[i] for i in rng.choice(len(_JOIN_AGGS), n_aggs,
                                              replace=False)]
    group = ["", "o_orderkey", "l_returnflag"][int(rng.integers(3))]
    sql = (f"select {group + ', ' if group else ''}{', '.join(aggs)} "
           f"from lineitem, orders where {' and '.join(conj)}")
    if group:
        sql += f" group by {group}"
    return sql
