"""The cross-engine differential's query set against SQLite: the port's
copy of the queries, date templating and value comparison of
tests/test_sqlite_differential.py (connectors/sqlite_backend.py holds
the other engine).  Query texts are in the common SQL subset; DATE
literals are templated ({d:ISO}) because sqlite stores dates as
epoch-day integers.  `normalize` brings both engines' results to one
representation for the verifier (verifier.verify with sqlite as the
control): dates as epoch days, decimals at the engine's scale (sqlite's
float rounded half up), strings without trailing blanks, doubles
compared as floats.
"""
import re
from decimal import ROUND_HALF_UP, Decimal

from ..connectors.sqlite_backend import day

SF = 0.01


def render(sql: str, dialect: str) -> str:
    def sub(m):
        iso = m.group(1)
        return f"DATE '{iso}'" if dialect == "engine" else str(day(iso))
    return re.sub(r"\{d:([0-9-]+)\}", sub, sql)


QUERIES = {
    "q6_revenue": """
        SELECT sum(extendedprice * discount) AS revenue
        FROM lineitem
        WHERE shipdate >= {d:1994-01-01} AND shipdate < {d:1995-01-01}
          AND discount BETWEEN 0.05 AND 0.07 AND quantity < 24""",
    "q1_aggregates": """
        SELECT returnflag, linestatus, sum(quantity) AS sum_qty,
               sum(extendedprice) AS sum_price, avg(discount) AS avg_disc,
               count(*) AS n
        FROM lineitem WHERE shipdate <= {d:1998-09-02}
        GROUP BY returnflag, linestatus
        ORDER BY returnflag, linestatus""",
    "q3_join_topn": """
        SELECT l.orderkey AS okey,
               sum(l.extendedprice * (1 - l.discount)) AS revenue
        FROM customer c, orders o, lineitem l
        WHERE c.mktsegment = 'BUILDING' AND c.custkey = o.custkey
          AND l.orderkey = o.orderkey
          AND o.orderdate < {d:1995-03-15} AND l.shipdate > {d:1995-03-15}
        GROUP BY l.orderkey ORDER BY revenue DESC, okey LIMIT 10""",
    "q4_exists": """
        SELECT o.orderpriority AS pri, count(*) AS n
        FROM orders o
        WHERE o.orderdate >= {d:1993-07-01} AND o.orderdate < {d:1993-10-01}
          AND EXISTS (SELECT 1 FROM lineitem l
                      WHERE l.orderkey = o.orderkey
                        AND l.commitdate < l.receiptdate)
        GROUP BY o.orderpriority ORDER BY pri""",
    "q5_six_way": """
        SELECT n.name AS nname,
               sum(l.extendedprice * (1 - l.discount)) AS revenue
        FROM customer c, orders o, lineitem l, supplier s, nation n, region r
        WHERE c.custkey = o.custkey AND l.orderkey = o.orderkey
          AND l.suppkey = s.suppkey AND c.nationkey = s.nationkey
          AND s.nationkey = n.nationkey AND n.regionkey = r.regionkey
          AND r.name = 'ASIA'
          AND o.orderdate >= {d:1994-01-01} AND o.orderdate < {d:1995-01-01}
        GROUP BY n.name ORDER BY revenue DESC""",
    "q10_returns": """
        SELECT c.custkey AS ck,
               sum(l.extendedprice * (1 - l.discount)) AS revenue
        FROM customer c, orders o, lineitem l
        WHERE c.custkey = o.custkey AND l.orderkey = o.orderkey
          AND o.orderdate >= {d:1993-10-01} AND o.orderdate < {d:1994-01-01}
          AND l.returnflag = 'R'
        GROUP BY c.custkey ORDER BY revenue DESC, ck LIMIT 20""",
    "left_join_counts": """
        SELECT c.custkey AS ck, count(o.orderkey) AS n
        FROM customer c LEFT JOIN orders o ON c.custkey = o.custkey
        GROUP BY c.custkey ORDER BY n DESC, ck LIMIT 25""",
    "in_subquery": """
        SELECT count(*) AS n FROM orders
        WHERE custkey IN (SELECT custkey FROM customer WHERE nationkey = 5)""",
    "scalar_subquery": """
        SELECT count(*) AS n FROM lineitem
        WHERE quantity < (SELECT avg(quantity) FROM lineitem)""",
    "distinct_count": """
        SELECT count(DISTINCT custkey) AS n, count(*) AS total
        FROM orders""",
    "having": """
        SELECT custkey AS ck, count(*) AS n FROM orders
        GROUP BY custkey HAVING count(*) >= 25 ORDER BY n DESC, ck""",
    "string_like": """
        SELECT count(*) AS n FROM part WHERE name LIKE '%green%'""",
    "union_all": """
        SELECT 'c' AS tag, count(*) AS n FROM customer
        UNION ALL SELECT 'o' AS tag, count(*) AS n FROM orders
        ORDER BY tag""",
    "case_sum": """
        SELECT sum(CASE WHEN discount > 0.05 THEN extendedprice ELSE 0 END)
               AS hi
        FROM lineitem WHERE shipdate < {d:1993-01-01}""",
    "min_max": """
        SELECT min(orderdate) AS lo, max(orderdate) AS hi,
               min(totalprice) AS plo, max(totalprice) AS phi
        FROM orders""",
}


def num_eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    # engine DATE renders ISO; sqlite stores epoch days
    if isinstance(a, str) and isinstance(b, int) \
            and re.fullmatch(r"\d{4}-\d{2}-\d{2}", a):
        return day(a) == b
    if isinstance(b, str) and isinstance(a, int) \
            and re.fullmatch(r"\d{4}-\d{2}-\d{2}", b):
        return a == day(b)
    if isinstance(a, (int, float, Decimal)) and isinstance(
            b, (int, float, Decimal)):
        fa, fb = float(a), float(b)
        if fa == fb:
            return True
        # Presto decimal aggregates round to the column scale (e.g.
        # avg(decimal(12,2)) is a decimal(12,2)); sqlite computes in
        # float — allow half an ulp at the decimal's scale
        ulp = 0.0
        for v in (a, b):
            if isinstance(v, Decimal):
                ulp = max(ulp, 0.5 * 10.0 ** v.as_tuple().exponent)
        if ulp and abs(fa - fb) <= ulp * 1.0000001:
            return True
        return abs(fa - fb) / max(abs(fa), abs(fb), 1e-30) < 1e-9
    if isinstance(a, str) or isinstance(b, str):
        return str(a).rstrip() == str(b).rstrip()
    return a == b


def date_to_days(v):
    import datetime
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    return v


def normalize(result, types):
    """A QueryResult of either engine in the verifier's common form:
    `types` are the engine's planned output types."""
    from ..common.types import (DateType, DecimalType, DoubleType,
                                RealType, VarcharType, CharType)
    from ..exec.runner import QueryResult
    rows = []
    for row in result.rows:
        out = []
        for v, t in zip(row, types):
            if v is None:
                out.append(None)
            elif isinstance(t, DateType):
                out.append(day(v) if isinstance(v, str)
                           else date_to_days(v))
            elif isinstance(t, DecimalType):
                q = Decimal(1).scaleb(-t.scale)
                out.append(Decimal(repr(float(v))).quantize(
                    q, rounding=ROUND_HALF_UP) if isinstance(v, float)
                    else Decimal(v).quantize(q))
            elif isinstance(t, (DoubleType, RealType)):
                out.append(float(v))
            elif isinstance(t, (VarcharType, CharType)):
                out.append(str(v).rstrip())
            else:
                out.append(int(v))
        rows.append(out)
    out_types = [DoubleType() if isinstance(t, (DoubleType, RealType))
                 else None for t in types]
    return QueryResult(list(result.column_names), out_types, rows)
