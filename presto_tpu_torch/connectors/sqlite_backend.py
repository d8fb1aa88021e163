"""A host copy of presto_tpu/connectors/sqlite_backend.py.

SQLite cross-engine backend for the verifier: a second, fully
independent SQL engine (parser, planner, executor all from sqlite3) over
the SAME TPC-H data, giving the correctness anchor the round-1 verdict
asked for — engine-vs-own-oracle shares the plan IR, engine-vs-sqlite
shares only the generated rows.

The analog of the reference's H2 differential harness
(presto-tests/.../QueryAssertions.java:52 runs every query on Presto and
on H2 over identical TPC-H tables) with sqlite in H2's seat.

Storage mapping: BIGINT/INTEGER -> INTEGER, DOUBLE -> REAL,
DECIMAL(p,s) -> REAL (descaled; compared with float tolerance),
DATE -> INTEGER epoch days (queries use day('1994-01-01') literals),
VARCHAR/CHAR -> TEXT.
"""
from __future__ import annotations

import datetime
import sqlite3
from typing import Dict, List, Optional

import numpy as np

from ..common.types import (CharType, DateType, DecimalType, DoubleType,
                            RealType, VarcharType)
from . import catalog


def day(iso: str) -> int:
    """Epoch-day literal for sqlite query texts (our DATE storage)."""
    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


_CHUNK = 1 << 16


def export_table(conn: sqlite3.Connection, table: str, sf: float,
                 connector_id: Optional[str] = None) -> None:
    cid = connector_id or catalog.resolve_table(table)
    schema = catalog.schema(table, cid)
    names = [n for n, _t in schema]
    types = [t for _n, t in schema]
    cols_sql = ", ".join(
        f"{n} {_sqlite_type(t)}" for n, t in schema)
    conn.execute(f"DROP TABLE IF EXISTS {table}")
    conn.execute(f"CREATE TABLE {table} ({cols_sql})")
    total = catalog.table_row_count(table, sf, cid)
    placeholders = ", ".join("?" * len(names))
    for start in range(0, total, _CHUNK):
        n = min(_CHUNK, total - start)
        cols = []
        for name, typ in zip(names, types):
            raw = catalog.generate_column(table, name, sf, start, n, cid)
            nulls = None
            if isinstance(raw, catalog.HostColumn):
                nulls = raw.nulls
                raw = raw.values
            if isinstance(raw, tuple):
                codes, values = raw
                vals = [values[c] for c in codes]
            elif isinstance(raw, list):
                vals = raw
            else:
                arr = np.asarray(raw)
                if isinstance(typ, DecimalType):
                    vals = (arr.astype(np.float64)
                            / (10.0 ** typ.scale)).tolist()
                elif isinstance(typ, (DoubleType, RealType)):
                    vals = arr.astype(np.float64).tolist()
                else:
                    vals = arr.tolist()
            if nulls is not None:
                vals = [None if nu else v for v, nu in zip(vals, nulls)]
            cols.append(vals)
        conn.executemany(
            f"INSERT INTO {table} VALUES ({placeholders})",
            list(zip(*cols)))
    conn.commit()


def _sqlite_type(t) -> str:
    if isinstance(t, (DoubleType, RealType, DecimalType)):
        return "REAL"
    if isinstance(t, (VarcharType, CharType)):
        return "TEXT"
    return "INTEGER"      # bigint / integer / date(epoch days) / boolean


class SqliteRunner:
    """Executes query text against the exported TPC-H tables; returns an
    object shaped like exec.runner.QueryResult for the verifier."""

    def __init__(self, sf: float, tables: Optional[List[str]] = None):
        self.conn = sqlite3.connect(":memory:")
        for t in tables or ("nation", "region", "supplier", "customer",
                            "part", "partsupp", "orders", "lineitem"):
            export_table(self.conn, t, sf)

    def execute(self, sql: str):
        from ..exec.runner import QueryResult
        cur = self.conn.execute(sql)
        names = [d[0] for d in cur.description]
        rows = [list(r) for r in cur.fetchall()]
        return QueryResult(names, [None] * len(names), rows)
