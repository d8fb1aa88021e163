"""The scalar-function queries of the port's function set, as data: the
queries of tests/test_functions.py (MATH, STRING, DATE, BREADTH and
SHIFT_EDGE, over TPC-H at sf0.01) and the pad, ISO week, URL / JSON and
lazy-regexp cases, for the CPU tests (tests/test_torch_functions.py) and
the chip script's functions phase (benchmarks/functions_run.py).  `ALL`
is every query; `AT_SCALE` one kernel-eligible query per family over
lineitem, each a chain the scan kernels decline (PlanShape: its opcode is
the torch interpreter's alone)."""

MATH_QUERIES = [
    "SELECT orderkey, sqrt(totalprice) s FROM orders WHERE orderkey < 50",
    "SELECT orderkey, exp(discount) e, ln(extendedprice) l FROM lineitem "
    "WHERE orderkey < 30",
    "SELECT orderkey, power(quantity, 2) p, cbrt(extendedprice) c "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT orderkey, log2(totalprice) a, log10(totalprice) b FROM orders "
    "WHERE orderkey < 30",
    "SELECT orderkey, sin(discount) s, cos(discount) c, tan(discount) t "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT orderkey, asin(discount) s, acos(discount) c, atan(tax) t "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT orderkey, degrees(discount) d, radians(quantity) r "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT orderkey, ceiling(totalprice) c, floor(totalprice) f, "
    "sign(acctbal) s FROM orders, customer "
    "WHERE orderkey < 10 AND custkey < 10",
    "SELECT orderkey, truncate(totalprice / 7.0) t FROM orders "
    "WHERE orderkey < 30",
    "SELECT orderkey, round(totalprice / 7.0) r0, "
    "round(totalprice / 7.0, 2) r2 FROM orders WHERE orderkey < 30",
    "SELECT orderkey, greatest(quantity, discount * 100) g, "
    "least(quantity, tax * 100) l FROM lineitem WHERE orderkey < 30",
    "SELECT orderkey, mod(orderkey, 7) m FROM orders WHERE orderkey < 30",
    "SELECT count(*) c FROM orders WHERE totalprice > pi() * 10000",
]

STRING_QUERIES = [
    "SELECT lower(mktsegment) l, upper(mktsegment) u, count(*) c "
    "FROM customer GROUP BY 1, 2",
    "SELECT reverse(shipmode) r, count(*) c FROM lineitem "
    "WHERE orderkey < 200 GROUP BY 1",
    "SELECT replace(shipmode, ' ', '_') r, count(*) c FROM lineitem "
    "WHERE orderkey < 200 GROUP BY 1",
    "SELECT strpos(mktsegment, 'U') p, count(*) c FROM customer "
    "GROUP BY 1 ORDER BY 1",
    "SELECT count(*) c FROM customer WHERE starts_with(mktsegment, 'BU')",
    "SELECT lpad(linestatus, 3, 'x') l, rpad(returnflag, 4, 'y') r, "
    "count(*) c FROM lineitem WHERE orderkey < 100 GROUP BY 1, 2",
    "SELECT concat(returnflag, linestatus) k, count(*) c FROM lineitem "
    "WHERE orderkey < 300 GROUP BY 1 ORDER BY 1",
    "SELECT concat(returnflag, '_', linestatus) k, count(*) c "
    "FROM lineitem WHERE orderkey < 300 GROUP BY 1 ORDER BY 1",
    "SELECT trim(rpad(returnflag, 3, ' ')) t, count(*) c FROM lineitem "
    "WHERE orderkey < 100 GROUP BY 1",
]

DATE_QUERIES = [
    "SELECT date_trunc('month', orderdate) m, count(*) c FROM orders "
    "WHERE orderkey < 2000 GROUP BY 1 ORDER BY 1",
    "SELECT date_trunc('quarter', orderdate) q, date_trunc('year', "
    "orderdate) y, count(*) c FROM orders WHERE orderkey < 2000 "
    "GROUP BY 1, 2 ORDER BY 1, 2",
    "SELECT date_trunc('week', shipdate) w, count(*) c FROM lineitem "
    "WHERE orderkey < 500 GROUP BY 1 ORDER BY 1",
    "SELECT orderkey, day_of_week(orderdate) dw, day_of_year(orderdate) dy,"
    " week(orderdate) w FROM orders WHERE orderkey < 400",
    "SELECT orderkey, date_add('day', 40, orderdate) a, "
    "date_add('month', 3, orderdate) b, date_add('year', -2, orderdate) c "
    "FROM orders WHERE orderkey < 200",
    # end-of-month clamping: Jan 31 + 1 month = Feb 28/29
    "SELECT orderkey, date_add('month', 1, date_trunc('month', orderdate)) "
    "a FROM orders WHERE orderkey < 200",
    "SELECT l.orderkey, date_diff('day', orderdate, shipdate) dd, "
    "date_diff('week', orderdate, shipdate) dw FROM orders o, lineitem l "
    "WHERE o.orderkey = l.orderkey AND o.orderkey < 100",
    "SELECT orderkey, date_diff('month', orderdate, "
    "DATE '1995-06-17') dm, date_diff('year', orderdate, "
    "DATE '1995-06-17') dy FROM orders WHERE orderkey < 300",
]

BREADTH_QUERIES = [
    # regexp over a dictionary column
    "SELECT shipmode, regexp_like(shipmode, '^A|L$') m FROM lineitem "
    "WHERE orderkey < 30",
    "SELECT regexp_extract(shipmode, '([A-Z]+) ?.*', 1) x, count(*) c "
    "FROM lineitem WHERE orderkey < 200 GROUP BY 1",
    "SELECT regexp_replace(shipmode, '[AEIOU]', '_') r FROM lineitem "
    "WHERE orderkey < 30",
    "SELECT split_part(shipinstruct, ' ', 1) a, "
    "split_part(shipinstruct, ' ', 9) b FROM lineitem WHERE orderkey < 30",
    "SELECT ends_with(shipmode, 'AIR') e, codepoint(returnflag) c "
    "FROM lineitem WHERE orderkey < 30",
    # math / bitwise
    "SELECT log(2.0, quantity) l, atan2(discount, tax + 0.01) a "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT sinh(discount) s, cosh(discount) c, tanh(discount) t "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT is_nan(discount / discount) n, is_finite(extendedprice) f "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT bitwise_and(orderkey, 255) a, bitwise_or(orderkey, 16) o, "
    "bitwise_xor(orderkey, partkey) x, bitwise_not(orderkey) n "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT bitwise_left_shift(orderkey, 3) l, "
    "bitwise_right_shift(orderkey, 1) r, "
    "bitwise_arithmetic_shift_right(0 - orderkey, 2) ar "
    "FROM lineitem WHERE orderkey < 30",
    "SELECT width_bucket(totalprice, 0.0, 600000.0, 10) w, count(*) c "
    "FROM orders WHERE orderkey < 2000 GROUP BY 1",
]

SHIFT_EDGE_QUERIES = [
    # counts at and past the width
    "SELECT orderkey, bitwise_left_shift(orderkey, 64) a, "
    "bitwise_left_shift(orderkey, 100) b FROM orders WHERE orderkey < 30",
    "SELECT orderkey, bitwise_right_shift(orderkey, 64) a, "
    "bitwise_right_shift(0 - orderkey, 70) b FROM orders "
    "WHERE orderkey < 30",
    "SELECT orderkey, bitwise_arithmetic_shift_right(0 - orderkey, 64) a, "
    "bitwise_arithmetic_shift_right(orderkey, 65) b FROM orders "
    "WHERE orderkey < 30",
    # negative counts -> NULL
    "SELECT orderkey, bitwise_left_shift(orderkey, -1) a, "
    "bitwise_right_shift(orderkey, -2) b, "
    "bitwise_arithmetic_shift_right(orderkey, -3) c FROM orders "
    "WHERE orderkey < 30",
    # per-row mixed signs / magnitudes through a column count
    "SELECT orderkey, bitwise_left_shift(orderkey, orderkey - 15) s "
    "FROM orders WHERE orderkey < 40",
    "SELECT orderkey, bitwise_right_shift(orderkey, orderkey * 3) s "
    "FROM orders WHERE orderkey < 40",
]

EXTRA_QUERIES = [
    # pad semantics
    "SELECT lpad(linestatus, 5, 'ab') l, count(*) c FROM lineitem "
    "WHERE orderkey < 50 GROUP BY 1",
    # ISO week numbers around Jan 1 and Dec 28-31
    "SELECT orderdate, week(orderdate) w FROM orders "
    "WHERE month(orderdate) = 1 AND day(orderdate) <= 4 "
    "AND orderkey < 20000",
    "SELECT orderdate, week(orderdate) w FROM orders "
    "WHERE month(orderdate) = 12 AND day(orderdate) >= 28 "
    "AND orderkey < 20000",
    # URL / JSON over literals
    "SELECT url_extract_protocol('https://api.example.com:8443/v1/q"
    "?x=1#frag') p, url_extract_host('https://api.example.com:8443/"
    "v1/q?x=1') h, url_extract_port('https://api.example.com:8443/') "
    "n, url_extract_path('https://api.example.com:8443/v1/q') pa, "
    "url_extract_query('https://e.com/p?a=1&b=2') q",
    "SELECT json_extract_scalar('{\"a\": {\"b\": [1, 2, 3]}}', "
    "'$.a.b[1]') x, json_extract_scalar('{\"s\": \"hi\"}', '$.s') y, "
    "json_extract_scalar('{\"t\": true}', '$.t') z, "
    "json_extract_scalar('{\"a\": 1}', '$.missing') w",
    # regexp over a late-materialized column: hoisted to the host
    "SELECT count(*) FROM orders WHERE orderkey < 2000 "
    "AND regexp_like(comment, 'furious|pend')",
    "SELECT regexp_replace(comment, '[aeiou]', '') r, count(*) c "
    "FROM orders WHERE orderkey < 300 GROUP BY 1",
]

ALL = (MATH_QUERIES + STRING_QUERIES + DATE_QUERIES + BREADTH_QUERIES
       + SHIFT_EDGE_QUERIES + EXTRA_QUERIES)

# family -> a lineitem aggregation by a dictionary key whose filter or
# aggregate arguments run one of the new opcodes
AT_SCALE = {
    "math": "select l_linestatus, sum(round(l_extendedprice, 0)), "
            "sum(sqrt(l_quantity)) from lineitem group by l_linestatus",
    "date": "select l_returnflag, count(*), "
            "sum(date_diff('day', l_shipdate, l_receiptdate)) "
            "from lineitem where day_of_week(l_shipdate) = 3 "
            "group by l_returnflag",
    "string": "select l_returnflag, count(*) from lineitem "
              "where concat(l_returnflag, l_linestatus) in ('RF', 'NO') "
              "group by l_returnflag",
    "bitwise": "select l_linestatus, sum(bitwise_and(l_orderkey, 7)), "
               "sum(bitwise_right_shift(l_partkey, 2)) from lineitem "
               "group by l_linestatus",
    "width_bucket": "select l_returnflag, sum(width_bucket("
                    "l_extendedprice, 0.0, 110000.0, 10)) from lineitem "
                    "group by l_returnflag",
}
