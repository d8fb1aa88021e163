"""Device-side column generation for the tpch and tpcds connectors
(torch).

The host generators in tpch.py / tpcds.py are pure counter-hash
functions of the row index, so numeric and dictionary-coded columns are
produced straight into device memory.  Every function mirrors
presto_tpu's connectors/device_gen.py bit for bit: the same splitmix64,
seeds and arithmetic (floor divisions and products in int64), with
uint64 emulated in int64 (exec/operators.py splitmix64, lsr, umod).
Generated: TPC-H lineitem, orders, customer, part, partsupp and
supplier; TPC-DS store_sales, web_sales and web_returns (every column)
and item, customer and customer_address (the reference's subsets).
Open-domain strings keep the late-materialized row-id path, and formula
strings and the small dimension tables (nation, region, date_dim, ...)
stay host-generated (`supported` says no).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import tpch as H
from . import tpcds as DS
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
# tpcds (seeds are namespaced "tpcds.<table>")
# ---------------------------------------------------------------------------

def _ds_uniform(table, column, idx, lo, hi):
    return _uniform("tpcds." + table, column, idx, lo, hi)


def _ds_store_sales(column: str, idx, sf: float):
    L = DS.LINES_PER_ORDER
    if column == "ss_sold_time_sk":
        return _ds_uniform("store_sales", "time", idx // L, 28800, 75600)
    if column == "ss_cdemo_sk":
        return _ds_uniform("store_sales", "cdemo", idx // L, 1,
                           DS._table_rows("customer_demographics", sf))
    if column == "ss_hdemo_sk":
        return _ds_uniform("store_sales", "hdemo", idx // L, 1,
                           DS._table_rows("household_demographics", sf))
    if column == "ss_addr_sk":
        return _ds_uniform("store_sales", "addr", idx // L, 1,
                           DS._table_rows("customer_address", sf))
    if column == "ss_ext_list_price":
        return (_ds_store_sales("ss_list_price", idx, sf)
                * _ds_store_sales("ss_quantity", idx, sf))
    if column == "ss_coupon_amt":
        return _ds_uniform("store_sales", "coupon", idx, 0, 50000) \
            * (_ds_uniform("store_sales", "hascoup", idx, 0, 9) == 0)
    if column == "ss_sold_date_sk":
        return DS.JULIAN_BASE + _ds_uniform("store_sales", "sold", idx // L,
                                            DS.SALES_MIN, DS.SALES_MAX)
    if column == "ss_item_sk":
        return _ds_uniform("store_sales", "item", idx, 1,
                           DS._table_rows("item", sf))
    if column == "ss_customer_sk":
        return _ds_uniform("store_sales", "cust", idx // L, 1,
                           DS._table_rows("customer", sf))
    if column == "ss_store_sk":
        return _ds_uniform("store_sales", "store", idx // L, 1,
                           DS._table_rows("store", sf))
    if column == "ss_promo_sk":
        return _ds_uniform("store_sales", "promo", idx, 1,
                           DS._table_rows("promotion", sf))
    if column == "ss_ticket_number":
        return idx // L + 1
    if column == "ss_quantity":
        return _ds_uniform("store_sales", "qty", idx, 1, 100)
    if column == "ss_wholesale_cost":
        return _ds_uniform("store_sales", "wholesale", idx, 100, 10000)
    if column == "ss_list_price":
        w = _ds_store_sales("ss_wholesale_cost", idx, sf)
        return w + w * _ds_uniform("store_sales", "markup", idx, 0, 200) // 100
    if column == "ss_sales_price":
        lp = _ds_store_sales("ss_list_price", idx, sf)
        return lp * _ds_uniform("store_sales", "dscnt", idx, 20, 100) // 100
    if column == "ss_ext_sales_price":
        return (_ds_store_sales("ss_sales_price", idx, sf)
                * _ds_store_sales("ss_quantity", idx, sf))
    if column == "ss_ext_discount_amt":
        lp = _ds_store_sales("ss_list_price", idx, sf)
        sp = _ds_store_sales("ss_sales_price", idx, sf)
        return (lp - sp) * _ds_store_sales("ss_quantity", idx, sf)
    if column == "ss_net_paid":
        return _ds_store_sales("ss_ext_sales_price", idx, sf)
    if column == "ss_net_profit":
        q = _ds_store_sales("ss_quantity", idx, sf)
        w = _ds_store_sales("ss_wholesale_cost", idx, sf)
        return _ds_store_sales("ss_net_paid", idx, sf) - q * w
    if column == "ss_ext_tax":
        return _ds_store_sales("ss_ext_sales_price", idx, sf) * 9 // 100
    if column == "ss_ext_wholesale_cost":
        return (_ds_store_sales("ss_wholesale_cost", idx, sf)
                * _ds_store_sales("ss_quantity", idx, sf))
    if column == "ss_net_paid_inc_tax":
        return (_ds_store_sales("ss_net_paid", idx, sf)
                + _ds_store_sales("ss_ext_tax", idx, sf))
    raise KeyError(column)


def _ds_web_sales(column: str, idx, sf: float):
    order = idx // DS.LINES_PER_ORDER
    if column == "ws_ship_mode_sk":
        return _ds_uniform("web_sales", "shipmode", order, 1,
                           DS._table_rows("ship_mode", sf))
    if column == "ws_sold_date_sk":
        return DS.JULIAN_BASE + _ds_uniform("web_sales", "sold", order,
                                            DS.SALES_MIN, DS.SALES_MAX)
    if column == "ws_ship_date_sk":
        sold = _ds_uniform("web_sales", "sold", order,
                           DS.SALES_MIN, DS.SALES_MAX)
        return DS.JULIAN_BASE + sold + _ds_uniform("web_sales", "lag",
                                                   idx, 1, 120)
    if column == "ws_item_sk":
        return _ds_uniform("web_sales", "item", idx, 1,
                           DS._table_rows("item", sf))
    if column == "ws_bill_customer_sk":
        return _ds_uniform("web_sales", "cust", order, 1,
                           DS._table_rows("customer", sf))
    if column == "ws_ship_addr_sk":
        return _ds_uniform("web_sales", "addr", order, 1,
                           DS._table_rows("customer_address", sf))
    if column == "ws_web_site_sk":
        return _ds_uniform("web_sales", "site", order, 1,
                           DS._table_rows("web_site", sf))
    if column == "ws_warehouse_sk":
        return _ds_uniform("web_sales", "wh", idx, 1,
                           DS._table_rows("warehouse", sf))
    if column == "ws_promo_sk":
        return _ds_uniform("web_sales", "promo", idx, 1,
                           DS._table_rows("promotion", sf))
    if column == "ws_order_number":
        return order + 1
    if column == "ws_quantity":
        return _ds_uniform("web_sales", "qty", idx, 1, 100)
    if column == "ws_sales_price":
        return _ds_uniform("web_sales", "price", idx, 100, 30000)
    if column == "ws_ext_sales_price":
        return (_ds_web_sales("ws_sales_price", idx, sf)
                * _ds_web_sales("ws_quantity", idx, sf))
    if column == "ws_ext_ship_cost":
        return _ds_uniform("web_sales", "shipcost", idx, 0, 50000)
    if column == "ws_net_paid":
        return _ds_web_sales("ws_ext_sales_price", idx, sf)
    if column == "ws_net_profit":
        return (_ds_web_sales("ws_net_paid", idx, sf)
                - _ds_uniform("web_sales", "cost", idx, 50, 40000)
                * _ds_web_sales("ws_quantity", idx, sf))
    if column == "ws_sold_time_sk":
        return _ds_uniform("web_sales", "time", order, 0, 86399)
    if column == "ws_bill_addr_sk":
        return _ds_uniform("web_sales", "baddr", order, 1,
                           DS._table_rows("customer_address", sf))
    if column == "ws_bill_cdemo_sk":
        return _ds_uniform("web_sales", "bcdemo", order, 1,
                           DS._table_rows("customer_demographics", sf))
    if column == "ws_bill_hdemo_sk":
        return _ds_uniform("web_sales", "bhdemo", order, 1,
                           DS._table_rows("household_demographics", sf))
    if column == "ws_ship_customer_sk":
        buyer = _ds_web_sales("ws_bill_customer_sk", idx, sf)
        other = _ds_uniform("web_sales", "shipcust", order, 1,
                            DS._table_rows("customer", sf))
        same = _ds_uniform("web_sales", "shipsame", order, 0, 9) < 7
        return torch.where(same, buyer, other)
    if column == "ws_ship_cdemo_sk":
        return _ds_uniform("web_sales", "scdemo", order, 1,
                           DS._table_rows("customer_demographics", sf))
    if column == "ws_ship_hdemo_sk":
        return _ds_uniform("web_sales", "shdemo", order, 1,
                           DS._table_rows("household_demographics", sf))
    if column == "ws_web_page_sk":
        return _ds_uniform("web_sales", "page", order, 1,
                           DS._table_rows("web_page", sf))
    if column == "ws_wholesale_cost":
        return _ds_uniform("web_sales", "wholesale", idx, 100, 10000)
    if column == "ws_list_price":
        w = _ds_web_sales("ws_wholesale_cost", idx, sf)
        return w + w * _ds_uniform("web_sales", "markup", idx, 0, 200) // 100
    if column == "ws_ext_list_price":
        return (_ds_web_sales("ws_list_price", idx, sf)
                * _ds_web_sales("ws_quantity", idx, sf))
    if column == "ws_ext_discount_amt":
        lp = _ds_web_sales("ws_list_price", idx, sf)
        return ((lp - _ds_web_sales("ws_sales_price", idx, sf))
                * _ds_web_sales("ws_quantity", idx, sf)).clamp(min=0)
    if column == "ws_ext_wholesale_cost":
        return (_ds_web_sales("ws_wholesale_cost", idx, sf)
                * _ds_web_sales("ws_quantity", idx, sf))
    if column == "ws_ext_tax":
        return _ds_web_sales("ws_ext_sales_price", idx, sf) * 9 // 100
    if column == "ws_coupon_amt":
        return _ds_uniform("web_sales", "coupon", idx, 0, 50000) \
            * (_ds_uniform("web_sales", "hascoup", idx, 0, 9) == 0)
    if column == "ws_net_paid_inc_tax":
        return (_ds_web_sales("ws_net_paid", idx, sf)
                + _ds_web_sales("ws_ext_tax", idx, sf))
    if column == "ws_net_paid_inc_ship":
        return (_ds_web_sales("ws_net_paid", idx, sf)
                + _ds_web_sales("ws_ext_ship_cost", idx, sf))
    raise KeyError(column)


def _ds_web_returns(column: str, idx, sf: float):
    n_orders = DS._table_rows("web_sales", sf) // DS.LINES_PER_ORDER
    if column == "wr_order_number":
        # monotone in the row index (host mirror: tpcds._gen_web_returns)
        # so order-number ranges are contiguous row ranges — the
        # co-bucket property bucket_layout depends on
        n_returns = DS._table_rows("web_returns", sf)
        return (idx.to(torch.int64) * max(1, n_orders)) // n_returns + 1
    if column == "wr_returned_date_sk":
        return DS.JULIAN_BASE + _ds_uniform("web_returns", "ret", idx,
                                            DS.SALES_MIN, DS.SALES_MAX + 60)
    if column == "wr_item_sk":
        return _ds_uniform("web_returns", "item", idx, 1,
                           DS._table_rows("item", sf))
    if column == "wr_refunded_customer_sk":
        return _ds_uniform("web_returns", "cust", idx, 1,
                           DS._table_rows("customer", sf))
    if column == "wr_return_quantity":
        return _ds_uniform("web_returns", "qty", idx, 1, 50)
    if column == "wr_return_amt":
        return _ds_uniform("web_returns", "amt", idx, 100, 500000)
    if column == "wr_net_loss":
        return _ds_uniform("web_returns", "loss", idx, 50, 100000)
    if column == "wr_returning_customer_sk":
        buyer = _ds_web_returns("wr_refunded_customer_sk", idx, sf)
        other = _ds_uniform("web_returns", "rcust", idx, 1,
                            DS._table_rows("customer", sf))
        same = _ds_uniform("web_returns", "rsame", idx, 0, 9) < 8
        return torch.where(same, buyer, other)
    if column == "wr_refunded_addr_sk":
        return _ds_uniform("web_returns", "faddr", idx, 1,
                           DS._table_rows("customer_address", sf))
    if column == "wr_returning_addr_sk":
        return _ds_uniform("web_returns", "raddr", idx, 1,
                           DS._table_rows("customer_address", sf))
    if column == "wr_refunded_cdemo_sk":
        return _ds_uniform("web_returns", "fcdemo", idx, 1,
                           DS._table_rows("customer_demographics", sf))
    if column == "wr_returning_cdemo_sk":
        return _ds_uniform("web_returns", "rcdemo", idx, 1,
                           DS._table_rows("customer_demographics", sf))
    if column == "wr_refunded_hdemo_sk":
        return _ds_uniform("web_returns", "fhdemo", idx, 1,
                           DS._table_rows("household_demographics", sf))
    if column == "wr_web_page_sk":
        return _ds_uniform("web_returns", "page", idx, 1,
                           DS._table_rows("web_page", sf))
    if column == "wr_reason_sk":
        return _ds_uniform("web_returns", "reason", idx, 1,
                           DS._table_rows("reason", sf))
    if column == "wr_returned_time_sk":
        return _ds_uniform("web_returns", "time", idx, 0, 86399)
    if column == "wr_refunded_cash":
        amt = _ds_web_returns("wr_return_amt", idx, sf)
        return amt * _ds_uniform("web_returns", "cashfrac", idx,
                                 0, 100) // 100
    if column == "wr_reversed_charge":
        amt = _ds_web_returns("wr_return_amt", idx, sf)
        cash = _ds_web_returns("wr_refunded_cash", idx, sf)
        return (amt - cash) // 2
    if column == "wr_account_credit":
        amt = _ds_web_returns("wr_return_amt", idx, sf)
        cash = _ds_web_returns("wr_refunded_cash", idx, sf)
        rev = _ds_web_returns("wr_reversed_charge", idx, sf)
        return amt - cash - rev
    if column == "wr_fee":
        return _ds_uniform("web_returns", "fee", idx, 50, 10000)
    if column == "wr_return_ship_cost":
        return _ds_uniform("web_returns", "shipc", idx, 0, 25000)
    if column == "wr_return_tax":
        return _ds_web_returns("wr_return_amt", idx, sf) * 9 // 100
    if column == "wr_return_amt_inc_tax":
        return (_ds_web_returns("wr_return_amt", idx, sf)
                + _ds_web_returns("wr_return_tax", idx, sf))
    raise KeyError(column)


def _ds_item(column: str, idx, sf: float):
    if column == "i_item_sk":
        return idx + 1
    if column == "i_current_price":
        return _ds_uniform("item", "price", idx, 99, 9999)
    if column == "i_brand_id":
        return _ds_uniform("item", "brand", idx, 0, len(DS.BRANDS) - 1) + 1001
    if column == "i_brand":
        return _ds_uniform("item", "brand", idx, 0,
                           len(DS.BRANDS) - 1).to(torch.int32)
    if column == "i_class_id":
        return _ds_uniform("item", "class", idx, 0, len(DS.CLASSES) - 1) + 1
    if column == "i_class":
        return _ds_uniform("item", "class", idx, 0,
                           len(DS.CLASSES) - 1).to(torch.int32)
    if column == "i_category_id":
        return _ds_uniform("item", "category", idx, 0,
                           len(DS.CATEGORIES) - 1) + 1
    if column == "i_category":
        return _ds_uniform("item", "category", idx, 0,
                           len(DS.CATEGORIES) - 1).to(torch.int32)
    if column == "i_manufact_id":
        return _ds_uniform("item", "manufact", idx, 1, 1000)
    if column == "i_color":
        return _ds_uniform("item", "color", idx, 0,
                           len(DS.COLORS) - 1).to(torch.int32)
    if column == "i_manager_id":
        return _ds_uniform("item", "manager", idx, 1, 100)
    raise KeyError(column)


def _ds_customer(column: str, idx, sf: float):
    if column == "c_customer_sk":
        return idx + 1
    if column == "c_current_addr_sk":
        return _ds_uniform("customer", "addr", idx, 1,
                           DS._table_rows("customer_address", sf))
    if column == "c_first_name":
        return _ds_uniform("customer", "first", idx, 0,
                           len(DS.FIRST_NAMES) - 1).to(torch.int32)
    if column == "c_last_name":
        return _ds_uniform("customer", "last", idx, 0,
                           len(DS.LAST_NAMES) - 1).to(torch.int32)
    if column == "c_birth_year":
        return _ds_uniform("customer", "byear", idx, 1924, 1992)
    if column == "c_birth_month":
        return _ds_uniform("customer", "bmonth", idx, 1, 12)
    if column == "c_birth_country":
        return _ds_uniform("customer", "bcountry", idx, 0, 4) \
            .to(torch.int32)
    raise KeyError(column)


def _ds_customer_address(column: str, idx, sf: float):
    if column == "ca_address_sk":
        return idx + 1
    if column == "ca_city":
        return _ds_uniform("customer_address", "city", idx, 0,
                           len(DS.CITIES) - 1).to(torch.int32)
    if column == "ca_county":
        return _ds_uniform("customer_address", "county", idx, 0,
                           len(DS.COUNTIES) - 1).to(torch.int32)
    if column == "ca_state":
        return _ds_uniform("customer_address", "state", idx, 0,
                           len(DS.STATES) - 1).to(torch.int32)
    if column == "ca_country":
        return torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    if column == "ca_gmt_offset":
        return -100 * _ds_uniform("customer_address", "gmt", idx, 5, 8)
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
    ("tpcds", "store_sales"): (_ds_store_sales, set(
        c for c, _ in DS.SCHEMAS["store_sales"])),
    ("tpcds", "web_sales"): (_ds_web_sales, set(
        c for c, _ in DS.SCHEMAS["web_sales"])),
    ("tpcds", "web_returns"): (_ds_web_returns, set(
        c for c, _ in DS.SCHEMAS["web_returns"])),
    ("tpcds", "item"): (_ds_item, {
        "i_item_sk", "i_current_price", "i_brand_id", "i_brand",
        "i_class_id", "i_class", "i_category_id", "i_category",
        "i_manufact_id", "i_color", "i_manager_id"}),
    ("tpcds", "customer"): (_ds_customer, {
        "c_customer_sk", "c_current_addr_sk", "c_first_name", "c_last_name",
        "c_birth_year", "c_birth_month", "c_birth_country"}),
    ("tpcds", "customer_address"): (_ds_customer_address, {
        "ca_address_sk", "ca_city", "ca_county", "ca_state", "ca_country",
        "ca_gmt_offset"}),
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
    ("tpcds", "item", "i_brand"): tuple(DS.BRANDS),
    ("tpcds", "item", "i_class"): tuple(DS.CLASSES),
    ("tpcds", "item", "i_category"): tuple(DS.CATEGORIES),
    ("tpcds", "item", "i_color"): tuple(DS.COLORS),
    ("tpcds", "customer", "c_first_name"): tuple(DS.FIRST_NAMES),
    ("tpcds", "customer", "c_last_name"): tuple(DS.LAST_NAMES),
    ("tpcds", "customer", "c_birth_country"): (
        "UNITED STATES", "CANADA", "MEXICO", "GERMANY", "JAPAN"),
    ("tpcds", "customer_address", "ca_city"): tuple(DS.CITIES),
    ("tpcds", "customer_address", "ca_county"): tuple(DS.COUNTIES),
    ("tpcds", "customer_address", "ca_state"): tuple(DS.STATES),
    ("tpcds", "customer_address", "ca_country"): ("United States",),
}

# resident-storage encoding hints (storage/encodings.py): lineitem rows
# are grouped by order, so orderkey is monotone; shippriority is the
# constant 0; the TPC-DS sales and returns rows are grouped by order (the
# co-bucket layout, tpcds.bucket_layout)
_ENCODING_HINTS: Dict[Tuple[str, str, str], str] = {
    ("tpch", "lineitem", "orderkey"): "rle",
    ("tpch", "orders", "shippriority"): "rle",
    ("tpcds", "web_sales", "ws_order_number"): "rle",
    ("tpcds", "web_returns", "wr_order_number"): "rle",
    ("tpcds", "store_sales", "ss_ticket_number"): "rle",
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
