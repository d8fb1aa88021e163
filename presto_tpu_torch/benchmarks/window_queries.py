"""Window-function queries over TPC-H orders: the window slice's queries,
run by chip_smoke.py at SF10 on the card and held against the reference
package by tests/test_torch_window*.py.  Each W query is ONE WindowNode
(one window kernel launch per run) under an ORDER BY ... LIMIT 100, which
keeps the result small and deterministic.

  W1  a running balance per customer: sum(o_totalprice) and row_number()
      over (partition by o_custkey order by o_orderkey) -- about 1 M
      partitions of about 15 rows at SF10.
  W2  each customer's top three orders since 1995: rank(), dense_rank()
      and count(*) over (partition by o_custkey order by o_totalprice
      desc) behind a WHERE that leaves dead rows in the batch, with a
      streaming Filter (rk <= 3) over the window output.
  W3  a running decimal average by priority over time: avg(o_totalprice)
      and count(o_totalprice) over (partition by o_orderpriority order by
      o_orderdate) -- 5 partitions of about 3 M rows at SF10, a
      dictionary-coded partition key and peer groups of about 1 250 rows,
      so segments and peer groups span thousands of the kernel's tiles.
  W1_LAG  W1 with lag(o_totalprice): outside the kernel's functions, so
      it declines WindowFunctionShape and runs operators.window_batch.
  W_GLOBAL, W_SINGLE_ROW  the kernel's edges over all of orders: no
      PARTITION BY (one segment), and partitions of one row each.

The reference's window shapes: KERNEL_SHAPES and window_fuzz_sql(seed)
from tests/test_window_kernel.py (the kernel's functions, the single-row
and global-partition edges), and SHAPES, the conformance bank of
tests/test_window.py (value functions, ntile, percent_rank / cume_dist,
ROWS / RANGE frames, min / max over a dictionary column) for
operators.window_batch.  The bank's window over a join (the streaming
join is not ported) is left out, as is the kernel test's NULL-argument
query, whose CASE the port's lowering does not have (NULL arguments are
tested at the operator level).
"""
import numpy as np

W1 = """
select o_custkey, o_orderkey,
       sum(o_totalprice) over (partition by o_custkey
                               order by o_orderkey) as running,
       row_number() over (partition by o_custkey
                          order by o_orderkey) as rn
from orders
order by running desc, o_orderkey
limit 100
"""

W2 = """
select o_custkey, o_orderkey, o_totalprice, rk, drk, cnt
from (select o_custkey, o_orderkey, o_totalprice,
             rank() over (partition by o_custkey
                          order by o_totalprice desc) as rk,
             dense_rank() over (partition by o_custkey
                                order by o_totalprice desc) as drk,
             count(*) over (partition by o_custkey
                            order by o_totalprice desc) as cnt
      from orders
      where o_orderdate >= date '1995-01-01')
where rk <= 3
order by o_totalprice desc, o_orderkey
limit 100
"""

W3 = """
select o_orderpriority, o_orderdate,
       avg(o_totalprice) over (partition by o_orderpriority
                               order by o_orderdate) as running_avg,
       count(o_totalprice) over (partition by o_orderpriority
                                 order by o_orderdate) as n
from orders
order by o_orderpriority, o_orderdate
limit 100
"""

W1_LAG = """
select o_custkey, o_orderkey,
       sum(o_totalprice) over (partition by o_custkey
                               order by o_orderkey) as running,
       lag(o_totalprice) over (partition by o_custkey
                               order by o_orderkey) as prev
from orders
order by running desc, o_orderkey
limit 100
"""

# the kernel's edges at full scale: one global segment, single-row
# partitions
W_GLOBAL = """
select o_orderkey,
       sum(o_totalprice) over (order by o_orderkey) as s,
       rank() over (order by o_orderkey) as r
from orders
order by s desc, o_orderkey
limit 10
"""

W_SINGLE_ROW = """
select o_orderkey,
       sum(o_totalprice) over (partition by o_orderkey
                               order by o_orderkey) as s,
       count(*) over (partition by o_orderkey order by o_orderkey) as c
from orders
order by s desc, o_orderkey
limit 10
"""

# tests/test_window_kernel.py: the kernel's functions and edges
KERNEL_SHAPES = {
    "running_sum": """
        select custkey, orderkey,
               sum(totalprice) over (partition by custkey
                                     order by orderkey) as running
        from orders where orderkey < 4000""",
    "ranking": (
        "select custkey, orderkey, "
        "row_number() over (partition by custkey order by orderdate, "
        "orderkey) as rn, "
        "rank() over (partition by custkey order by orderdate, "
        "orderkey) as rk, "
        "dense_rank() over (partition by custkey order by orderdate, "
        "orderkey) as dr "
        "from orders where orderkey < 4000"),
    "count_avg": (
        "select custkey, orderkey, "
        "count(*) over (partition by custkey order by orderkey) as c, "
        "avg(totalprice) over (partition by custkey "
        "order by orderkey) as a "
        "from orders where orderkey < 4000"),
    "single_row_partitions": (
        "select orderkey, sum(totalprice) over (partition by orderkey "
        "order by orderkey) as s, count(*) over (partition by orderkey "
        "order by orderkey) as c from orders where orderkey < 3000"),
    "global_partition": (
        "select orderkey, sum(totalprice) over (order by orderkey) as s, "
        "rank() over (order by orderkey) as r "
        "from orders where orderkey < 3000"),
}

_FUNCS = ["row_number()", "rank()", "dense_rank()", "count(*)",
          "count(totalprice)", "sum(totalprice)", "avg(totalprice)"]
# multi-row partitions, single-row partitions, one global partition and a
# dictionary-coded partition key
_PARTS = ["partition by custkey", "partition by orderkey", "",
          "partition by orderpriority"]


def window_fuzz_sql(seed: int) -> str:
    """The reference's randomized window query for `seed`
    (tests/test_window_kernel.py _window_fuzz_sql)."""
    rng = np.random.default_rng(seed)
    part = _PARTS[int(rng.integers(len(_PARTS)))]
    order = ["order by orderkey",
             "order by orderdate, orderkey"][int(rng.integers(2))]
    over = f"over ({part}{' ' if part else ''}{order})"
    n = int(rng.integers(2, 5))
    funcs = [_FUNCS[i] for i in rng.choice(len(_FUNCS), n, replace=False)]
    sel = ", ".join(f"{f} {over} as w{i}" for i, f in enumerate(funcs))
    hi = int(rng.integers(2000, 12_000))
    return (f"select custkey, orderkey, {sel} "
            f"from orders where orderkey < {hi}")


# tests/test_window.py SHAPES, without the window over a join
SHAPES = {
    "row_number": """
        SELECT custkey, orderkey,
               row_number() OVER (PARTITION BY custkey ORDER BY orderkey)
        FROM orders WHERE orderkey < 2000""",
    "rank_dense": """
        SELECT orderkey, rank() OVER (ORDER BY orderpriority),
               dense_rank() OVER (ORDER BY orderpriority)
        FROM orders WHERE orderkey < 400""",
    "running_sum": """
        SELECT custkey, orderkey,
               sum(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey)
        FROM orders WHERE orderkey < 4000""",
    "global_agg": """
        SELECT orderkey, avg(totalprice) OVER () FROM orders
        WHERE orderkey < 500""",
    "lag_default": """
        SELECT custkey, orderkey,
               lag(orderkey) OVER (PARTITION BY custkey ORDER BY orderkey),
               lag(orderkey, 2, -1) OVER (PARTITION BY custkey
                                          ORDER BY orderkey)
        FROM orders WHERE orderkey < 4000""",
    "lead": """
        SELECT custkey, orderkey,
               lead(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey)
        FROM orders WHERE orderkey < 4000""",
    "first_last_value": """
        SELECT custkey, orderkey,
               first_value(orderkey) OVER (PARTITION BY custkey
                                           ORDER BY orderkey),
               last_value(orderkey) OVER (PARTITION BY custkey
                                          ORDER BY orderkey)
        FROM orders WHERE orderkey < 4000""",
    "last_value_full_frame": """
        SELECT custkey, orderkey,
               last_value(orderkey) OVER (
                   PARTITION BY custkey ORDER BY orderkey
                   RANGE BETWEEN UNBOUNDED PRECEDING
                             AND UNBOUNDED FOLLOWING)
        FROM orders WHERE orderkey < 4000""",
    "nth_value": """
        SELECT custkey, orderkey,
               nth_value(orderkey, 2) OVER (
                   PARTITION BY custkey ORDER BY orderkey
                   ROWS BETWEEN UNBOUNDED PRECEDING
                            AND UNBOUNDED FOLLOWING)
        FROM orders WHERE orderkey < 4000""",
    "ntile": """
        SELECT orderkey, ntile(4) OVER (ORDER BY totalprice)
        FROM orders WHERE orderkey < 800""",
    "percent_rank": """
        SELECT orderkey, percent_rank() OVER (ORDER BY orderpriority),
               cume_dist() OVER (ORDER BY orderpriority)
        FROM orders WHERE orderkey < 400""",
    "rows_preceding": """
        SELECT custkey, orderkey,
               sum(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey
                                     ROWS 2 PRECEDING)
        FROM orders WHERE orderkey < 4000""",
    "rows_between": """
        SELECT custkey, orderkey,
               sum(totalprice) OVER (
                   PARTITION BY custkey ORDER BY orderkey
                   ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING)
        FROM orders WHERE orderkey < 4000""",
    "rows_moving_min_max": """
        SELECT custkey, orderkey,
               min(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey
                                     ROWS BETWEEN 2 PRECEDING
                                              AND CURRENT ROW),
               max(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey
                                     ROWS BETWEEN 2 PRECEDING
                                              AND CURRENT ROW)
        FROM orders WHERE orderkey < 4000""",
    "rows_following_only": """
        SELECT custkey, orderkey,
               count(*) OVER (PARTITION BY custkey ORDER BY orderkey
                              ROWS BETWEEN 1 FOLLOWING AND 2 FOLLOWING)
        FROM orders WHERE orderkey < 4000""",
    "rows_unbounded_following": """
        SELECT custkey, orderkey,
               sum(totalprice) OVER (
                   PARTITION BY custkey ORDER BY orderkey
                   ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING)
        FROM orders WHERE orderkey < 4000""",
    "range_unbounded_both": """
        SELECT custkey, orderkey,
               count(*) OVER (PARTITION BY custkey ORDER BY orderkey
                              RANGE BETWEEN UNBOUNDED PRECEDING
                                        AND UNBOUNDED FOLLOWING)
        FROM orders WHERE orderkey < 4000""",
    "min_max_string": """
        SELECT orderkey,
               max(orderpriority) OVER (ORDER BY orderkey
                                        ROWS 3 PRECEDING)
        FROM orders WHERE orderkey < 800""",
    "multi_specs": """
        SELECT orderkey,
               row_number() OVER (ORDER BY totalprice),
               sum(totalprice) OVER (PARTITION BY orderpriority
                                     ORDER BY orderkey)
        FROM orders WHERE orderkey < 800""",
    "empty_input": """
        SELECT orderkey, lag(totalprice) OVER (ORDER BY orderkey)
        FROM orders WHERE orderkey < 0""",
    "same_spec_different_frames": """
        SELECT custkey, orderkey,
               sum(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey
                                     ROWS 1 PRECEDING),
               sum(totalprice) OVER (PARTITION BY custkey ORDER BY orderkey
                                     ROWS 3 PRECEDING)
        FROM orders WHERE orderkey < 4000""",
}
