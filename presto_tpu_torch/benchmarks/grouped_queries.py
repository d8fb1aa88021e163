"""GROUP BY queries beyond the direct kernel's 64 groups, over lineitem:
the grouped-aggregation slice's queries, run by chip_smoke.py on the card
and held against the reference package by tests/test_torch_grouped*.py.

  S1  TPC-H Q1's aggregates by ship mode and ship instruction as well:
      span slots, G = 3 * 2 * 7 * 4 = 168.
  H1  TPC-H Q6's parameter grid (revenue per quantity and discount over
      one ship year): hash slots over two open decimal keys.
  H2  Q1 by line number with a float64 accumulator: hash slots over two
      dictionary keys and one open integer key.
  S2  S1's keys plus seven boolean keys: span slots, G = 168 * 2**7 =
      21504.  No user's query -- it drives the span kernel's wide layout,
      which lineitem's string keys alone cannot reach.
  SPAN_F  S1's keys with float sums and integer / float min and max
      ("span-f"): the span kernel's float rows and min / max folds, which
      S1 leaves out.
  SPAN_F_CTA  S1's keys and five boolean keys (G = 5376) with a float
      sum: a float table fits in shared memory once per CTA but not once
      per warp, so the span kernel applies its warps' staged floats in
      order between CTA barriers.
"""

S1 = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
order by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
"""

H1 = """
select l_quantity, l_discount, sum(l_extendedprice * l_discount) as revenue,
       count(*) as n
from lineitem
where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
group by l_quantity, l_discount
order by l_quantity, l_discount
"""

H2 = """
select l_returnflag, l_linestatus, l_linenumber,
       sum(cast(l_extendedprice as double)) as s, count(*) as n
from lineitem
where l_shipdate <= date '1998-09-02'
group by 1, 2, 3
order by 1, 2, 3
"""

S2 = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       l_quantity > 25 as q25, l_discount > 0.05 as d05, l_tax > 0.04 as t04,
       l_extendedprice > 30000 as p30k,
       l_shipdate > date '1995-06-17' as late, l_linenumber > 3 as ln3,
       l_quantity > 40 as q40, count(*) as n, sum(l_extendedprice) as s
from lineitem
group by 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11
"""

SPAN_F = (
    "select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct, "
    "sum(cast(l_extendedprice as double)) as s, min(l_quantity) as mn, "
    "max(cast(l_discount as double)) as mx, max(l_orderkey) as mo, "
    "count(l_tax) as c from lineitem group by 1, 2, 3, 4")

SPAN_F_CTA = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       l_quantity > 25 as q25, l_discount > 0.05 as d05, l_tax > 0.04 as t04,
       l_extendedprice > 30000 as p30k, l_linenumber > 3 as ln3,
       sum(cast(l_extendedprice as double)) as s, count(*) as n
from lineitem
group by 1, 2, 3, 4, 5, 6, 7, 8, 9
"""
