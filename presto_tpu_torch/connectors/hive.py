"""File-based warehouse connector over Parquet ("hive" analog).

A host copy of presto_tpu/connectors/hive.py: part files are
interchangeable between the two packages (the same `presto_type` field
metadata).  A REAL column reads as float64 values that are exact float32
values, the port's device representation of REAL (exec/batch.py).

The storage-backed counterpart of the generated tpch/tpcds connectors — the
slim analog of the reference's presto-hive connector + presto-parquet and
presto-orc readers/writers (presto-hive/.../HiveConnector,
presto-parquet/.../reader/ParquetReader.java:95,
presto-orc/.../OrcReader.java:64 — both formats ride pyarrow here, the
way the reference rides its own columnar readers)
with the table-write commit protocol of TableWriterOperator.java:78 /
TableFinishOperator.java (stage part files in a hidden temp dir, atomic
rename on finish).

Layout: `<warehouse>/<table>/part-*.{parquet,orc}` (hive.storage-format
selects the written format; reads accept either).  Each part file stores columns
in the engine's device representation (decimals as scaled int64, dates as
int32 days, varchars as strings) with the Presto type recorded in parquet
field metadata (`presto_type`), so round-trips are exact; external parquet
files without the metadata are mapped from their arrow types (decimal128 is
converted to scaled int64 on read).

The connector implements the same duck-typed surface the catalog dispatches
over (SCHEMAS / PREFIXES / OPEN_DOMAIN / ROWID_* / table_row_count /
generate_column / generate_values_at / column_type — see catalog.py), which
is what lets every engine layer (planner, device pipeline, numpy reference
interpreter, distributed scheduler) read hive tables with no special cases:
a split is a row range, and `generate_column` serves it from row groups.

String columns are served as codes into a TABLE-WIDE dictionary built on
first access: jitted consumers require one stable dictionary per column
across batches (exec/pipeline.py caches resolution on the first batch).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.types import (BigintType, BooleanType, CharType, DateType,
                            DecimalType, DoubleType, IntegerType, RealType,
                            SmallintType, TinyintType, Type, VarcharType,
                            parse_type)

OPEN_DOMAIN: set = set()
ROWID_ORDERED: set = set()
ROWID_DISTINCT: set = set()


def _arrow():
    import pyarrow
    import pyarrow.parquet
    return pyarrow


def _type_from_arrow(field) -> Type:
    """Arrow field -> Presto type (field metadata wins when present)."""
    import pyarrow as pa
    md = field.metadata or {}
    pt = md.get(b"presto_type")
    if pt:
        return parse_type(pt.decode())
    t = field.type
    if pa.types.is_boolean(t):
        return BooleanType()
    if pa.types.is_int8(t):
        return TinyintType()
    if pa.types.is_int16(t):
        return SmallintType()
    if pa.types.is_int32(t):
        return IntegerType()
    if pa.types.is_int64(t):
        return BigintType()
    if pa.types.is_float32(t):
        return RealType()
    if pa.types.is_float64(t):
        return DoubleType()
    if pa.types.is_date32(t):
        return DateType()
    if pa.types.is_decimal(t):
        return DecimalType(t.precision, t.scale)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return VarcharType(None)
    raise NotImplementedError(f"unsupported parquet type {t}")


def _stat_float(v) -> float:
    """Parquet row-group statistic -> float in logical units (pyarrow hands
    back datetime.date for date32 columns, Decimal for decimal128)."""
    import datetime
    if isinstance(v, datetime.date):
        return float((v - datetime.date(1970, 1, 1)).days)
    return float(v)


def _np_dtype_for(typ: Type):
    if isinstance(typ, BooleanType):
        return np.bool_
    if isinstance(typ, (IntegerType, DateType)):
        return np.int32
    if isinstance(typ, (TinyintType, SmallintType)):
        return np.int32
    if isinstance(typ, (DoubleType, RealType)):
        return np.float64
    return np.int64


class _OrcPart:
    """ORC part file with the slice of the ParquetFile surface the table
    reader uses (presto-orc's OrcReader role; pyarrow's ORC reader
    underneath).  ORC footers expose no per-stripe min/max through
    pyarrow, so column_stats counts rows only for ORC parts."""

    def __init__(self, path: str):
        from pyarrow import orc
        self._f = orc.ORCFile(path)
        self.schema_arrow = self._f.schema
        self.num_rows = self._f.nrows

    def read(self, columns=None):
        return self._f.read(columns=columns)


class _Table:
    """One on-disk table: parquet parts + lazily built per-column state."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path)
        self._lock = threading.Lock()
        self._files: Optional[List] = None       # ParquetFile handles
        self._offsets: Optional[List[int]] = None  # cumulative row starts
        self._schema: Optional[List[Tuple[str, Type]]] = None
        self._dicts: Dict[str, Tuple[Tuple[str, ...], Dict[str, int]]] = {}
        self._col_cache: Dict[str, Tuple] = {}    # column -> (values, nulls)
        self._stats_cache: Dict[str, object] = {}

    def _parts(self) -> List[str]:
        return sorted(os.path.join(self.path, f)
                      for f in os.listdir(self.path)
                      if f.endswith(".parquet") or f.endswith(".orc"))

    def _open(self):
        import pyarrow.parquet as pq
        with self._lock:
            if self._files is None:
                self._files = [
                    _OrcPart(p) if p.endswith(".orc")
                    else pq.ParquetFile(p) for p in self._parts()]
                self._offsets = [0]
                for f in self._files:
                    n = (f.num_rows if isinstance(f, _OrcPart)
                         else f.metadata.num_rows)
                    self._offsets.append(self._offsets[-1] + n)
                if self._files:
                    sch = self._files[0].schema_arrow
                    self._schema = [(f.name, _type_from_arrow(f))
                                    for f in sch]
                else:
                    self._schema = []
        return self._files

    def invalidate(self):
        with self._lock:
            self._files = None
            self._offsets = None
            self._schema = None
            self._dicts.clear()
            self._col_cache.clear()
            self._stats_cache.clear()

    @property
    def schema(self) -> List[Tuple[str, Type]]:
        self._open()
        return self._schema

    def row_count(self) -> int:
        self._open()
        return self._offsets[-1]

    def column_type(self, column: str) -> Type:
        for n, t in self.schema:
            if n == column:
                return t
        raise KeyError(f"{self.name}.{column}")

    # -- column read ------------------------------------------------------

    def _read_full_column(self, column: str):
        """Whole column as (numpy values in device repr, nulls or None).
        Cached: hive tables are read-mostly and column-cached reads make
        row-range splits O(slice) — the analog of the reference's data cache
        (presto-cache)."""
        got = self._col_cache.get(column)
        if got is not None:
            return got
        import pyarrow as pa
        typ = self.column_type(column)
        # decode PER PART: a table may mix parquet parts (decimals as
        # scaled int64 + field metadata, dates as int32) with ORC parts
        # (decimal128, date32) — each part normalizes to the device
        # representation before the numpy concat, so mixed-format tables
        # read correctly (pa.concat_arrays would reject the mixed types)
        if isinstance(typ, (VarcharType, CharType)):
            vals: list = []
            null_chunks = []
            for f in self._open():
                arr = f.read(columns=[column]).column(0)
                vals.extend(arr.to_pylist())
            uniq, index = self._dictionary(column, vals)
            codes = np.zeros(len(vals), dtype=np.int32)
            nm = np.zeros(len(vals), dtype=bool)
            for i, sv in enumerate(vals):
                if sv is None:
                    nm[i] = True
                else:
                    codes[i] = index[sv]
            nulls = nm if nm.any() else None
            out = (codes, uniq)
            self._col_cache[column] = (out, nulls)
            return (out, nulls)
        val_chunks = []
        null_chunks = []
        any_nulls = False
        for f in self._open():
            arr = f.read(columns=[column]).column(0)
            if hasattr(arr, "combine_chunks"):
                arr = arr.combine_chunks()
            if arr.null_count:
                any_nulls = True
                null_chunks.append(np.asarray(arr.is_null()))
            else:
                null_chunks.append(np.zeros(len(arr), dtype=bool))
            if pa.types.is_decimal(arr.type):
                scale = arr.type.scale
                py = arr.to_pylist()
                v = np.asarray(
                    [0 if x is None else int(x.scaleb(scale)) for x in py],
                    dtype=np.int64)
            else:
                if pa.types.is_date32(arr.type):
                    arr = arr.cast(_arrow().int32())
                v = np.asarray(arr.fill_null(0)
                               if arr.null_count else arr)
                v = v.astype(_np_dtype_for(typ), copy=False)
            val_chunks.append(v)
        values = (np.concatenate(val_chunks) if val_chunks
                  else np.zeros(0, dtype=_np_dtype_for(typ)))
        nulls = np.concatenate(null_chunks) if any_nulls else None
        self._col_cache[column] = (values, nulls)
        return (values, nulls)

    def _dictionary(self, column: str, vals=None):
        got = self._dicts.get(column)
        if got is None:
            assert vals is not None
            uniq = tuple(sorted({v for v in vals if v is not None}))
            got = (uniq, {s: i for i, s in enumerate(uniq)})
            self._dicts[column] = got
        return got

    def column_stats(self, column: str):
        """Column stats from parquet row-group metadata (the analog of the
        reference's HiveMetadata.getTableStatistics over file footers).
        Physical min/max are mapped back to logical units; results are
        cached per column — footers are re-read only after invalidate()."""
        import pyarrow as pa
        from ..sql.stats import ColumnStats
        cached = self._stats_cache.get(column)
        if cached is not None:
            return cached
        try:
            typ = self.column_type(column)
        except KeyError:
            return None
        lo = hi = None
        nulls = 0
        total = 0
        for f in self._open():
            if isinstance(f, _OrcPart):
                # no stripe min/max via pyarrow; nulls counted from the
                # column data (stats are cached, tables read-mostly) so
                # null_fraction stays truthful for ORC parts
                total += f.num_rows
                try:
                    nulls += f.read(columns=[column]).column(0).null_count
                except (KeyError, pa.lib.ArrowInvalid):
                    return None
                continue
            md = f.metadata
            try:
                field = f.schema_arrow.field(column)
                ci = [md.schema.column(i).name
                      for i in range(md.num_columns)].index(column)
            except (KeyError, ValueError):
                return None
            # physical type is PER FILE: a table can mix engine-written
            # parts (decimals as scaled int64) and external decimal128
            # parts — convert each file's min/max to logical units before
            # folding into the running lo/hi
            descale = 1.0
            if isinstance(typ, DecimalType) \
                    and not pa.types.is_decimal(field.type):
                descale = 10.0 ** typ.scale
            for rg in range(md.num_row_groups):
                col = md.row_group(rg).column(ci)
                total += col.num_values
                st = col.statistics
                if st is None:
                    continue
                if st.null_count is not None:
                    nulls += st.null_count
                if st.has_min_max and not isinstance(
                        typ, (VarcharType, CharType)):
                    try:
                        mn, mx = (_stat_float(st.min) / descale,
                                  _stat_float(st.max) / descale)
                    except (TypeError, ValueError):
                        continue
                    lo = mn if lo is None else min(lo, mn)
                    hi = mx if hi is None else max(hi, mx)
        ndv = None
        dcached = self._dicts.get(column)
        if dcached is not None:
            ndv = float(len(dcached[0]))
        out = ColumnStats(
            low=lo, high=hi, ndv=ndv,
            null_fraction=(nulls / total) if total else 0.0)
        self._stats_cache[column] = out
        return out

    def read_range(self, column: str, start: int, count: int):
        """Rows [start, start+count) of one column ->
        values | (codes, dict-tuple) | HostColumn-with-nulls (see catalog)."""
        from .catalog import HostColumn
        values, nulls = self._read_full_column(column)
        if isinstance(values, tuple):
            codes, uniq = values
            out_vals: object = (codes[start:start + count], list(uniq))
        else:
            out_vals = values[start:start + count]
        if nulls is not None:
            return HostColumn(out_vals, nulls[start:start + count])
        return out_vals

    def values_at(self, column: str, ids) -> list:
        values, nulls = self._read_full_column(column)
        ids = np.asarray(ids)
        if isinstance(values, tuple):
            codes, uniq = values
            out = [uniq[c] for c in codes[ids]]
        else:
            out = list(values[ids])
        if nulls is not None:
            nm = nulls[ids]
            out = [None if n else v for v, n in zip(out, nm)]
        return out


class _WriteHandle:
    """Staged write of one part file set (TableWriterOperator analog).

    Pages are appended to `<warehouse>/.staging-<id>/part-N.parquet`; commit
    atomically renames the staged files into the table directory (CTAS
    creates it, INSERT appends), mirroring the reference's rename-based
    commit in TableFinishOperator + metastore."""

    def __init__(self, conn: "HiveConnector", table: str,
                 names: List[str], types: List[Type],
                 storage_format: str = "PARQUET"):
        self.conn = conn
        self.table = table
        self.names = names
        self.types = types
        self.storage_format = storage_format
        self.staging_id = uuid.uuid4().hex[:12]
        self.staging_dir = os.path.join(conn.warehouse,
                                        f".staging-{self.staging_id}")
        os.makedirs(self.staging_dir, exist_ok=True)
        self._part = 0
        self.rows = 0
        conn._staged[self.staging_id] = self

    def write_page(self, page) -> int:
        import pyarrow as pa
        import pyarrow.parquet as pq
        from ..common.block import decode_to_flat
        cols, fields = [], []
        for name, typ, block in zip(self.names, self.types, page.blocks):
            flat = decode_to_flat(block)
            nulls = flat.null_mask()
            mask = pa.array(np.asarray(nulls, dtype=bool)) \
                if nulls is not None and np.any(nulls) else None
            if isinstance(typ, (VarcharType, CharType)):
                arr = pa.array([None if v is None else str(v)
                                for v in flat.to_pylist()], type=pa.string())
            elif isinstance(typ, BooleanType):
                arr = pa.array(np.asarray(flat.values, dtype=bool),
                               type=pa.bool_(), mask=mask)
            elif isinstance(typ, DoubleType):
                v = flat.values
                v = v.view(np.float64) if v.dtype != np.float64 else v
                arr = pa.array(v, type=pa.float64(), mask=mask)
            elif isinstance(typ, RealType):
                v = flat.values
                v = v.view(np.float32) if v.dtype != np.float32 else v
                arr = pa.array(v.astype(np.float64), type=pa.float64(),
                               mask=mask)
            elif isinstance(typ, (IntegerType, DateType)):
                arr = pa.array(np.asarray(flat.values, dtype=np.int32),
                               type=pa.int32(), mask=mask)
            elif isinstance(typ, DecimalType):
                ints = flat.to_pylist()
                if self.storage_format == "ORC":
                    # ORC keeps no arrow field metadata, so decimals must
                    # carry their LOGICAL type (decimal128) in-band
                    from decimal import Decimal
                    arr = pa.array(
                        [None if v is None
                         else Decimal(int(v)).scaleb(-typ.scale)
                         for v in ints],
                        type=pa.decimal128(typ.precision, typ.scale))
                else:
                    # parquet: scaled-integer device representation with
                    # the Presto type in field metadata; exact round-trip
                    # (long decimals beyond int64 are rejected)
                    arr = pa.array([None if v is None else int(v)
                                    for v in ints], type=pa.int64())
            else:
                arr = pa.array(np.asarray(flat.values, dtype=np.int64),
                               type=pa.int64(), mask=mask)
            if self.storage_format == "ORC":
                # ORC discards arrow field metadata: the LOGICAL type must
                # ride in-band (date32 / decimal128 / exact int widths);
                # CHAR reads back as VARCHAR (width metadata lost)
                if isinstance(typ, DateType):
                    arr = arr.cast(pa.date32())
                elif isinstance(typ, TinyintType):
                    arr = arr.cast(pa.int8())
                elif isinstance(typ, SmallintType):
                    arr = arr.cast(pa.int16())
                fields.append(pa.field(name, arr.type))
            else:
                fields.append(pa.field(name, arr.type,
                                       metadata={"presto_type": str(typ)}))
            cols.append(arr)
        table = pa.Table.from_arrays(cols, schema=pa.schema(fields))
        if self.storage_format == "ORC":
            from pyarrow import orc as pa_orc
            path = os.path.join(self.staging_dir,
                                f"part-{self._part}.orc")
            pa_orc.write_table(table, path)
        else:
            path = os.path.join(self.staging_dir,
                                f"part-{self._part}.parquet")
            pq.write_table(table, path)
        self._part += 1
        self.rows += page.position_count
        return page.position_count

    def commit(self) -> int:
        dest = os.path.join(self.conn.warehouse, self.table)
        os.makedirs(dest, exist_ok=True)
        prefix = uuid.uuid4().hex[:8]
        for f in sorted(os.listdir(self.staging_dir)):
            os.rename(os.path.join(self.staging_dir, f),
                      os.path.join(dest, f"part-{prefix}-{f.split('-')[1]}"))
        shutil.rmtree(self.staging_dir, ignore_errors=True)
        self.conn._staged.pop(self.staging_id, None)
        self.conn.refresh()
        return self.rows

    def abort(self):
        shutil.rmtree(self.staging_dir, ignore_errors=True)
        self.conn._staged.pop(self.staging_id, None)


class HiveConnector:
    """Duck-typed connector module over a warehouse directory."""

    OPEN_DOMAIN = OPEN_DOMAIN
    ROWID_ORDERED = ROWID_ORDERED
    ROWID_DISTINCT = ROWID_DISTINCT

    def __init__(self, warehouse: str, storage_format: str = "PARQUET"):
        if storage_format not in ("PARQUET", "ORC"):
            raise ValueError(
                f"unsupported hive.storage-format {storage_format!r}")
        self.storage_format = storage_format
        self.warehouse = os.path.abspath(warehouse)
        os.makedirs(self.warehouse, exist_ok=True)
        self._tables: Dict[str, _Table] = {}
        self._staged: Dict[str, _WriteHandle] = {}
        self.refresh()

    # -- metadata (ConnectorMetadata analog) ------------------------------

    def refresh(self):
        found = {}
        for entry in sorted(os.listdir(self.warehouse)):
            path = os.path.join(self.warehouse, entry)
            if entry.startswith(".") or not os.path.isdir(path):
                continue
            t = self._tables.get(entry)
            if t is None:
                t = _Table(path)
            else:
                t.invalidate()
            found[entry] = t
        self._tables = found

    @property
    def SCHEMAS(self) -> Dict[str, List[Tuple[str, Type]]]:
        return {name: t.schema for name, t in self._tables.items()}

    @property
    def PREFIXES(self) -> Dict[str, str]:
        return {name: "" for name in self._tables}

    def column_type(self, table: str, column: str) -> Type:
        return self._tables[table].column_type(column)

    def table_row_count(self, table: str, sf: float) -> int:
        return self._tables[table].row_count()

    # -- reads (ConnectorPageSource analog; splits are row ranges) --------

    def generate_column(self, table: str, column: str, sf: float,
                        start: int, count: int):
        return self._tables[table].read_range(column, start, count)

    def column_stats(self, table: str, column: str, sf: float):
        t = self._tables.get(table)
        return None if t is None else t.column_stats(column)

    def generate_values_at(self, table: str, column: str, sf: float, ids):
        return self._tables[table].values_at(column, ids)

    # -- writes (ConnectorPageSink analog) --------------------------------

    def begin_write(self, table: str, names: List[str],
                    types: List[Type]) -> _WriteHandle:
        # an INSERT into an existing table keeps that table's part format
        # (mixed-format tables read fine, but staying uniform keeps the
        # footer-stats path and external readers simple)
        fmt = self.storage_format
        t = self._tables.get(table)
        if t is not None:
            parts = t._parts()
            if parts:
                fmt = "ORC" if parts[0].endswith(".orc") else "PARQUET"
        return _WriteHandle(self, table, names, types, storage_format=fmt)

    def staged(self, staging_id: str) -> _WriteHandle:
        return self._staged[staging_id]

    def drop_table(self, table: str):
        t = self._tables.pop(table, None)
        if t is None:
            raise KeyError(f"unknown table {table!r}")
        shutil.rmtree(t.path, ignore_errors=True)
