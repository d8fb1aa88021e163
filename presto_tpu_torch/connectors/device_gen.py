"""Device-side column generation for the tpch connector (torch).

The host generators in tpch.py are pure counter-hash functions of the
row index, so numeric and dictionary-coded columns are produced straight
into device memory.  Every function mirrors presto_tpu's
connectors/device_gen.py bit for bit: the same splitmix64, seeds and
arithmetic, with uint64 emulated in int64 (exec/operators.py splitmix64,
lsr, umod).  Ported: lineitem and the TPC-H dimensions orders, customer,
part, partsupp and supplier; other tables (nation, region, TPC-DS) are not
device-generated yet (`supported` says no).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import tpch as H
from ..exec.operators import as_int64, lsr, splitmix64, umod

_GOLDEN = as_int64(0x9E3779B97F4A7C15)


def _dsplitmix64(x):
    return splitmix64(x)


def _cell(stream: str, column: str, idx):
    seed = as_int64(int(H._stream_seed(stream, column)))
    return _dsplitmix64(idx.to(torch.int64) * _GOLDEN + seed)


def _uniform(stream: str, column: str, idx, lo: int, hi: int):
    return umod(_cell(stream, column, idx), hi - lo + 1) + lo


# ---------------------------------------------------------------------------
# tpch lineitem
# ---------------------------------------------------------------------------

def _order_date(orderkey):
    return _uniform("orders", "orderdate", orderkey,
                    H.MIN_ORDER_DATE, H.MAX_ORDER_DATE)


def _retail_price(partkey):
    return 90000 + ((partkey // 10) % 20001) + 100 * (partkey % 1000)


def _li_suppkey(idx, sf):
    partkey = _uniform("lineitem", "partkey", idx, 1,
                       H._table_rows("part", sf))
    s = H._table_rows("supplier", sf)
    j = _uniform("lineitem", "suppj", idx, 0, 3)
    return ((partkey + j * (s // 4 + (partkey - 1) // s)) % s) + 1


_CUM_TABLES: Dict[str, torch.Tensor] = {}


def _li_cum_table(device):
    """(5040, 8) cumulative lines-per-order permutation table, one copy
    per device."""
    key = str(device)
    t = _CUM_TABLES.get(key)
    if t is None:
        _, cum = H._li_perm_tables()
        t = _CUM_TABLES[key] = torch.as_tensor(
            cum.astype("int32"), device=device)
    return t


def _li_order_map(idx, sf: float):
    """idx -> (orderkey, linenumber) under the 28-lineitems-per-7-orders
    block scheme (tpch._li_order_map)."""
    cum = _li_cum_table(idx.device)
    n_orders = H._table_rows("orders", sf)
    full = (n_orders // 7) * 28
    b = idx // 28
    r = (idx % 28).to(torch.int32)
    pid = umod(_cell("lineitem", "orderblock", b), 5040)
    crows = cum[pid]                                     # (n, 8)
    pos = (r[:, None] >= crows[:, 1:]).sum(dim=1)
    start = torch.gather(crows, 1, pos[:, None])[:, 0]
    orderkey = b * 7 + pos + 1
    linenumber = (r - start + 1).to(idx.dtype)
    tail = idx >= full
    t = idx - full
    orderkey = torch.where(tail, (n_orders // 7) * 7 + t // 4 + 1, orderkey)
    linenumber = torch.where(tail, t % 4 + 1, linenumber)
    return orderkey, linenumber


def _tpch_lineitem(column: str, idx, sf: float):
    if column == "orderkey":
        return _li_order_map(idx, sf)[0]
    if column == "linenumber":
        return _li_order_map(idx, sf)[1]
    if column == "partkey":
        return _uniform("lineitem", "partkey", idx, 1,
                        H._table_rows("part", sf))
    if column == "suppkey":
        return _li_suppkey(idx, sf)
    if column == "quantity":
        return _uniform("lineitem", "quantity", idx, 1, 50) * 100
    if column == "extendedprice":
        partkey = _uniform("lineitem", "partkey", idx, 1,
                           H._table_rows("part", sf))
        qty = _uniform("lineitem", "quantity", idx, 1, 50)
        return qty * _retail_price(partkey)
    if column == "discount":
        return _uniform("lineitem", "discount", idx, 0, 10)
    if column == "tax":
        return _uniform("lineitem", "tax", idx, 0, 8)
    if column == "shipdate":
        return _order_date(_li_order_map(idx, sf)[0]) \
            + _uniform("lineitem", "shipdays", idx, 1, 121)
    if column == "commitdate":
        return _order_date(_li_order_map(idx, sf)[0]) \
            + _uniform("lineitem", "commitdays", idx, 30, 90)
    if column == "receiptdate":
        sd = _tpch_lineitem("shipdate", idx, sf)
        return sd + _uniform("lineitem", "receiptdays", idx, 1, 30)
    if column == "returnflag":
        rd = _tpch_lineitem("receiptdate", idx, sf)
        coin = _uniform("lineitem", "rflagcoin", idx, 0, 1)
        return torch.where(rd <= H.CURRENT_DATE, coin * 2,
                           torch.ones_like(coin)).to(torch.int32)
    if column == "linestatus":
        sd = _tpch_lineitem("shipdate", idx, sf)
        return (sd > H.CURRENT_DATE).to(torch.int32)
    if column == "shipinstruct":
        return _uniform("lineitem", "instruct", idx, 0, 3).to(torch.int32)
    if column == "shipmode":
        return _uniform("lineitem", "shipmode", idx, 0, 6).to(torch.int32)
    raise KeyError(column)


# ---------------------------------------------------------------------------
# tpch dimension tables (the join slice's build sides)
# ---------------------------------------------------------------------------

def _tpch_orders(column: str, idx, sf: float):
    orderkey = idx + 1
    if column == "orderkey":
        return orderkey
    if column == "custkey":
        c = H._table_rows("customer", sf)
        raw = _uniform("orders", "custkey", idx, 1, c // 3 * 2)
        return raw + (raw - 1) // 2 if c >= 3 else raw
    if column == "orderstatus":
        od = _order_date(orderkey)
        return torch.where(od + 121 <= H.CURRENT_DATE, 0,
                           torch.where(od > H.CURRENT_DATE, 1, 2)) \
            .to(torch.int32)
    if column == "totalprice":
        return _uniform("orders", "totalprice", idx, 90000, 50000000)
    if column == "orderdate":
        return _order_date(orderkey)
    if column == "orderpriority":
        return _uniform("orders", "priority", idx, 0, 4).to(torch.int32)
    if column == "shippriority":
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    raise KeyError(column)


def _tpch_customer(column: str, idx, sf: float):
    if column == "custkey":
        return idx + 1
    if column == "nationkey":
        return _uniform("customer", "nationkey", idx, 0, 24)
    if column == "acctbal":
        return _uniform("customer", "acctbal", idx, -99999, 999999)
    if column == "mktsegment":
        return _uniform("customer", "segment", idx, 0, 4).to(torch.int32)
    raise KeyError(column)


def _tpch_part(column: str, idx, sf: float):
    partkey = idx + 1
    if column == "partkey":
        return partkey
    if column == "mfgr":
        return (_uniform("part", "mfgr", idx, 1, 5) - 1).to(torch.int32)
    if column == "brand":
        m = _uniform("part", "mfgr", idx, 1, 5)
        b = _uniform("part", "brand", idx, 1, 5)
        return ((m - 1) * 5 + (b - 1)).to(torch.int32)
    if column == "type":
        h = _cell("part", "type", idx)
        a = umod(h, 6)
        b = umod(lsr(h, 8), 5)
        c = umod(lsr(h, 16), 5)
        return (a * 25 + b * 5 + c).to(torch.int32)
    if column == "size":
        return _uniform("part", "size", idx, 1, 50)
    if column == "container":
        h = _cell("part", "container", idx)
        return (umod(h, 5) * 8 + umod(lsr(h, 8), 8)).to(torch.int32)
    if column == "retailprice":
        return _retail_price(partkey)
    raise KeyError(column)


def _tpch_partsupp(column: str, idx, sf: float):
    partkey = idx // 4 + 1
    if column == "partkey":
        return partkey
    if column == "suppkey":
        s = H._table_rows("supplier", sf)
        j = idx % 4
        return ((partkey + j * (s // 4 + (partkey - 1) // s)) % s) + 1
    if column == "availqty":
        return _uniform("partsupp", "availqty", idx, 1, 9999)
    if column == "supplycost":
        return _uniform("partsupp", "supplycost", idx, 100, 100000)
    raise KeyError(column)


def _tpch_supplier(column: str, idx, sf: float):
    if column == "suppkey":
        return idx + 1
    if column == "nationkey":
        return _uniform("supplier", "nationkey", idx, 0, 24)
    if column == "acctbal":
        return _uniform("supplier", "acctbal", idx, -99999, 999999)
    raise KeyError(column)


# ---------------------------------------------------------------------------
# registry + public API
# ---------------------------------------------------------------------------

_TABLES = {
    ("tpch", "lineitem"): (_tpch_lineitem, {
        "orderkey", "linenumber", "partkey", "suppkey", "quantity",
        "extendedprice", "discount", "tax", "shipdate", "commitdate",
        "receiptdate", "returnflag", "linestatus", "shipinstruct",
        "shipmode"}),
    ("tpch", "orders"): (_tpch_orders, {
        "orderkey", "custkey", "orderstatus", "totalprice", "orderdate",
        "orderpriority", "shippriority"}),
    ("tpch", "customer"): (_tpch_customer, {
        "custkey", "nationkey", "acctbal", "mktsegment"}),
    ("tpch", "part"): (_tpch_part, {
        "partkey", "mfgr", "brand", "type", "size", "container",
        "retailprice"}),
    ("tpch", "partsupp"): (_tpch_partsupp, {
        "partkey", "suppkey", "availqty", "supplycost"}),
    ("tpch", "supplier"): (_tpch_supplier, {
        "suppkey", "nationkey", "acctbal"}),
}

# dictionary value lists for the dict-coded columns above
_DICTS: Dict[Tuple[str, str, str], tuple] = {
    ("tpch", "lineitem", "returnflag"): tuple(H.RETURN_FLAGS),
    ("tpch", "lineitem", "linestatus"): tuple(H.STATUSES),
    ("tpch", "lineitem", "shipinstruct"): tuple(H.INSTRUCTIONS),
    ("tpch", "lineitem", "shipmode"): tuple(H.MODES),
    ("tpch", "orders", "orderstatus"): tuple(H.ORDER_STATUSES),
    ("tpch", "orders", "orderpriority"): tuple(H.PRIORITIES),
    ("tpch", "customer", "mktsegment"): tuple(H.SEGMENTS),
    ("tpch", "part", "mfgr"): tuple(H.MFGRS),
    ("tpch", "part", "brand"): tuple(H.BRANDS),
    ("tpch", "part", "type"): tuple(H.TYPES),
    ("tpch", "part", "container"): tuple(H.CONTAINERS),
}

# resident-storage encoding hints (storage/encodings.py): lineitem rows
# are grouped by order, so orderkey is monotone; shippriority is the
# constant 0
_ENCODING_HINTS: Dict[Tuple[str, str, str], str] = {
    ("tpch", "lineitem", "orderkey"): "rle",
    ("tpch", "orders", "shippriority"): "rle",
}


def encoding_hint(connector: str, table: str, column: str) -> Optional[str]:
    return _ENCODING_HINTS.get((connector, table, column))


def supported(connector: str, table: str, column: str) -> bool:
    entry = _TABLES.get((connector, table))
    return entry is not None and column in entry[1]


def dictionary(connector: str, table: str, column: str) -> Optional[tuple]:
    return _DICTS.get((connector, table, column))


def column(connector: str, table: str, column_name: str, sf: float, idx):
    """Generate one column for device row indices `idx` (int64 tensor)."""
    fn, _cols = _TABLES[(connector, table)]
    return fn(column_name, idx, sf)
