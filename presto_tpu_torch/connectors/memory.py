"""In-memory connector: writable tables living in process RAM, plus the
blackhole sink -- a host copy of presto_tpu/connectors/memory.py, the
analogs of the reference's presto-memory (MemoryPagesStore) and
presto-blackhole utility connectors.

Duck-typed connector contract (catalog.register_connector):
SCHEMAS/PREFIXES/OPEN_DOMAIN/ROWID_*/table_row_count/generate_column/
generate_values_at/column_stats, with begin_write/staged/drop_table for
CTAS/INSERT (staged-then-commit, so aborted writes leave nothing behind --
TableWriterOperator.java:78 + TableFinishOperator semantics).  The rows
are Python values on the host; a scan copies each chunk to the task's
device (pipeline._compile_TableScanNode host columns).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.block import block_to_values
from ..common.types import (BooleanType, CharType, DateType, DecimalType,
                            DoubleType, IntegerType, RealType, Type,
                            VarcharType)
from .catalog import HostColumn

_staging_ids = itertools.count(1)


class _MemTable:
    def __init__(self, schema: List[Tuple[str, Type]]):
        self.schema = schema
        # column name -> (list of python values, list of null flags)
        self.columns: Dict[str, tuple] = {n: ([], []) for n, _ in schema}
        self.rows = 0
        self._dicts: Dict[str, tuple] = {}   # table-wide varchar dicts

    def append_page(self, names: List[str], types: List[Type], page) -> int:
        for name, typ, block in zip(names, types, page.blocks):
            vals, nulls = self.columns[name]
            for v in block_to_values(typ, block):
                nulls.append(v is None)
                vals.append(v)
        self.rows += page.position_count
        self._dicts.clear()
        return page.position_count

    def read(self, column: str, start: int, count: int):
        vals, nulls = self.columns[column]
        typ = dict(self.schema)[column]
        if isinstance(typ, (VarcharType, CharType)):
            # dictionary must be TABLE-WIDE: scan chunks share one
            # code->string mapping (the engine groups/joins by codes)
            ent = self._dicts.get(column)
            if ent is None:
                uniq = sorted({v for v, n in zip(vals, nulls)
                               if not n and v is not None})
                index = {s: i for i, s in enumerate(uniq)}
                ent = (uniq or [""], index)
                self._dicts[column] = ent
            uniq, index = ent
            codes = np.array(
                [0 if (n or v is None) else index[v]
                 for v, n in zip(vals[start:start + count],
                                 nulls[start:start + count])],
                dtype=np.int32)
            nsel = nulls[start:start + count]
            if any(nsel):
                return HostColumn((codes, list(uniq)),
                                  np.array(nsel, dtype=bool))
            return (codes, list(uniq))
        sel = vals[start:start + count]
        nsel = nulls[start:start + count]
        return _to_connector_column(typ, sel, nsel)

    def values_at(self, column: str, ids) -> list:
        vals, nulls = self.columns[column]
        return [None if nulls[i] else vals[i] for i in np.asarray(ids)]


def _to_connector_column(typ: Type, vals: list, nulls: list):
    if isinstance(typ, (VarcharType, CharType)):
        uniq = sorted({v for v, n in zip(vals, nulls) if not n and
                       v is not None})
        index = {s: i for i, s in enumerate(uniq)}
        codes = np.array([0 if (n or v is None) else index[v]
                          for v, n in zip(vals, nulls)], dtype=np.int32)
        out = (codes, uniq or [""])
    elif isinstance(typ, DecimalType):
        scale = 10 ** typ.scale
        out = np.array([0 if n else int(round(float(v) * scale))
                        for v, n in zip(vals, nulls)], dtype=np.int64)
    elif isinstance(typ, (DoubleType, RealType)):
        out = np.array([0.0 if n else float(v)
                        for v, n in zip(vals, nulls)], dtype=np.float64)
    elif isinstance(typ, BooleanType):
        out = np.array([False if n else bool(v)
                        for v, n in zip(vals, nulls)], dtype=bool)
    elif isinstance(typ, DateType):
        import datetime
        epoch = datetime.date(1970, 1, 1)

        def days(v):
            if isinstance(v, str):
                v = datetime.date.fromisoformat(v)
            if isinstance(v, datetime.date):
                return (v - epoch).days
            return int(v)
        out = np.array([0 if n else days(v)
                        for v, n in zip(vals, nulls)], dtype=np.int32)
    else:
        dt = np.int32 if isinstance(typ, IntegerType) else np.int64
        out = np.array([0 if n else int(v)
                        for v, n in zip(vals, nulls)], dtype=dt)
    if any(nulls):
        return HostColumn(out, np.array(nulls, dtype=bool))
    return out


class _WriteHandle:
    def __init__(self, conn: "MemoryConnector", table: str,
                 names: List[str], types: List[Type]):
        self.conn = conn
        self.table = table
        self.names = names
        self.types = types
        self.staging_id = f"mem-{next(_staging_ids)}"
        self._staged = _MemTable(list(zip(names, types)))
        conn._staged[self.staging_id] = self

    def write_page(self, page) -> int:
        return self._staged.append_page(self.names, self.types, page)

    def commit(self) -> None:
        existing = self.conn._tables.get(self.table)
        if existing is None:
            self.conn._tables[self.table] = self._staged
        else:
            for name, (v, nl) in self._staged.columns.items():
                ev, en = existing.columns[name]
                ev.extend(v)
                en.extend(nl)
            existing.rows += self._staged.rows
        self.conn._staged.pop(self.staging_id, None)

    def abort(self) -> None:
        self.conn._staged.pop(self.staging_id, None)


class MemoryConnector:
    """Writable RAM-resident tables (presto-memory analog)."""

    OPEN_DOMAIN: set = set()
    ROWID_ORDERED: set = set()
    ROWID_DISTINCT: set = set()

    def __init__(self):
        self._tables: Dict[str, _MemTable] = {}
        self._staged: Dict[str, _WriteHandle] = {}

    @property
    def SCHEMAS(self):
        return {n: t.schema for n, t in self._tables.items()}

    @property
    def PREFIXES(self):
        return {n: "" for n in self._tables}

    def column_type(self, table: str, column: str) -> Type:
        return dict(self._tables[table].schema)[column]

    def table_row_count(self, table: str, sf: float) -> int:
        return self._tables[table].rows

    def generate_column(self, table: str, column: str, sf: float,
                        start: int, count: int):
        return self._tables[table].read(column, start, count)

    def generate_values_at(self, table: str, column: str, sf: float, ids):
        return self._tables[table].values_at(column, ids)

    def column_stats(self, table: str, column: str, sf: float):
        return None

    def begin_write(self, table: str, names: List[str],
                    types: List[Type]) -> _WriteHandle:
        return _WriteHandle(self, table, names, types)

    def staged(self, staging_id: str) -> _WriteHandle:
        return self._staged[staging_id]

    def drop_table(self, table: str):
        if table not in self._tables:
            raise KeyError(f"unknown table {table!r}")
        del self._tables[table]


class _BlackholeHandle:
    def __init__(self, conn, table):
        self.conn = conn
        self.staging_id = f"bh-{next(_staging_ids)}"
        conn._staged[self.staging_id] = self
        self.rows = 0

    def write_page(self, page) -> int:
        self.rows += page.position_count
        return page.position_count

    def commit(self) -> None:
        self.conn._staged.pop(self.staging_id, None)

    def abort(self) -> None:
        self.conn._staged.pop(self.staging_id, None)


class BlackholeConnector:
    """Swallows writes, serves no rows (presto-blackhole analog: the
    write-throughput benchmarking sink)."""

    OPEN_DOMAIN: set = set()
    ROWID_ORDERED: set = set()
    ROWID_DISTINCT: set = set()
    SCHEMAS: Dict[str, list] = {}
    PREFIXES: Dict[str, str] = {}

    def __init__(self):
        self._staged: Dict[str, _BlackholeHandle] = {}

    def begin_write(self, table, names, types) -> _BlackholeHandle:
        return _BlackholeHandle(self, table)

    def staged(self, staging_id: str) -> _BlackholeHandle:
        return self._staged[staging_id]
