"""Queries over lineitem on which the reference's scan kernel runs the
expression forms the port's kernels used to decline (negate, abs, date
parts, divide and modulus, CASE, COALESCE, IS NULL, IN, casts), run by
chip_smoke.py on the card through the direct, span and hash kernels and
held against the reference package by tests/test_torch_expr_ops.py.

IN_LIST compares the unscaled quantity with the integer constants, as the
reference's IN does (presto_tpu/exec/lowering.py _in converts a constant
with the value's type), so it counts no row.  CAST_DEC_INT keeps the
unscaled price, as the reference's cast to INTEGER does.
"""

QUERIES = {
    "in_list": ("select count(*), sum(l_extendedprice) from lineitem "
                "where l_quantity in (1, 2, 3)"),
    "negate": "select sum(-l_extendedprice) from lineitem",
    "abs": ("select l_returnflag, sum(abs(l_extendedprice - 50000)) "
            "from lineitem group by 1"),
    "extract_year": ("select extract(year from l_shipdate) as y, count(*) "
                     "from lineitem group by 1"),
    "cast_double_div": ("select sum(cast(l_extendedprice as double) / 3) "
                        "from lineitem"),
    "int_div_mod": ("select sum(l_linenumber / 2), sum(l_linenumber % 3) "
                    "from lineitem"),
    "case": ("select sum(case when l_discount > 0.05 then l_extendedprice "
             "else 0 end) from lineitem"),
    "coalesce": "select sum(coalesce(l_extendedprice, 0)) from lineitem",
    "is_not_null": ("select count(*) from lineitem "
                    "where l_extendedprice is not null"),
    "mod_group_key": ("select l_orderkey % 5 as k, count(*) from lineitem "
                      "group by 1"),
    "cast_dec_int": ("select sum(cast(l_extendedprice as integer)) "
                     "from lineitem"),
    # a decimal / decimal divide (the numerator scales up: DIVQS_I) in the
    # generated direct kernel and the hash kernel's interpreter
    "dec_div": "select sum(l_extendedprice / l_quantity) from lineitem",
    "hash_dec_div": ("select l_linenumber, l_returnflag, "
                     "sum(l_extendedprice / l_quantity) from lineitem "
                     "group by 1, 2"),
    # the new forms inside the span and hash kernels' plain versions
    "span_case": ("select l_returnflag, l_linestatus, l_shipmode, "
                  "l_shipinstruct, sum(case when l_quantity > 25 then "
                  "l_extendedprice / 7 else -l_extendedprice end), "
                  "count(nullif(l_linenumber, 1)) from lineitem "
                  "group by 1, 2, 3, 4"),
    "hash_date_parts": ("select l_linenumber, l_returnflag, "
                        "sum(l_quantity % 7), sum(year(l_shipdate)), "
                        "sum(quarter(l_shipdate)), sum(day(l_shipdate)), "
                        "count(*) from lineitem "
                        "where month(l_shipdate) in (1, 6) group by 1, 2"),
}

# Queries the kernels decline at SF1 and above, as the reference's do: a
# computed group key's estimate is the row count, past twice the hash
# table's slot cap (chip_smoke.py checks the decline; HASH_DATE_PARTS
# runs the date parts in the hash kernel under column keys instead).
DECLINED_AT_SCALE = {"mod_group_key": "AggGroupCardinality",
                     "extract_year": "AggGroupCardinality"}
