"""Process-wide device-resident columnar store with LRU eviction.

Generated connector data is immutable, so whole-table columns are
generated on the device ONCE (connectors/device_gen.py), encoded
(encodings.py), zone-mapped, and every scan reads the encoded bytes --
the port of presto_tpu/storage/store.py.  Residency is charged to an
exec.memory.MemoryPool:

- insertion evicts least-recently-used entries until the new column's
  encoded bytes fit the storage budget;
- a column that cannot fit even alone, or whose plain bytes exceed the
  per-column cap, is not cached (the scan then has no resident column).

One store exists per (device, budget, per-column cap).
"""
from __future__ import annotations

import threading

from collections import OrderedDict
from typing import Dict, Optional

import torch

from ..exec.memory import MemoryPool
from .encodings import (ResidentColumn, ZoneMaps, build_zone_maps,
                        encode_column)

DEFAULT_STORAGE_BUDGET = 6 << 30
# building a column transiently holds ~2x its plain bytes
DEFAULT_MAX_COLUMN_BYTES = 1 << 30
DEFAULT_ZONE_ROWS = 1 << 16
# columns at or under this row count take the host-side stats path
HOST_STATS_ROWS = 1 << 20

_STORAGE_COUNTERS = ("cache_hits", "cache_misses", "columns_built",
                     "build_rejected", "evictions", "resident_bytes",
                     "encoded_bytes", "plain_bytes",
                     "chunks_total", "chunks_skipped")


class StorageMetrics:
    """Storage counters (pushdown.prune_chunks bumps the chunk pair)."""

    def __init__(self):
        self._values: Dict[str, int] = {k: 0 for k in _STORAGE_COUNTERS}

    def reset(self) -> None:
        for k in _STORAGE_COUNTERS:
            self._values[k] = 0

    def incr(self, name: str, delta: int = 1) -> None:
        self._values[name] += delta

    def __setitem__(self, name: str, value: int) -> None:
        self._values[name] = value

    def snapshot(self) -> Dict[str, int]:
        return dict(self._values)


STORAGE_METRICS = StorageMetrics()


def reset_storage_metrics() -> None:
    STORAGE_METRICS.reset()


class ResidentEntry:
    """One cached column: encoded device arrays + host-side zone maps."""

    __slots__ = ("column", "zones", "nbytes", "pad")

    def __init__(self, column: ResidentColumn, zones: ZoneMaps, pad: int):
        self.column = column
        self.zones = zones
        self.nbytes = column.nbytes
        self.pad = pad


class ResidentStore:
    """LRU cache of ResidentEntry keyed (connector, table, column, sf,
    as_i32), charged to its own MemoryPool, on one device.  Statements
    run on server threads share it: a lock makes lookup, build and
    eviction one step, so two statements never build (and reserve) the
    same column twice."""

    def __init__(self, budget: Optional[int] = DEFAULT_STORAGE_BUDGET,
                 max_column_bytes: int = DEFAULT_MAX_COLUMN_BYTES,
                 device="cpu"):
        self.pool = MemoryPool(budget)
        self.max_column_bytes = max_column_bytes
        self.device = torch.device(device)
        self.entries: "OrderedDict[tuple, ResidentEntry]" = OrderedDict()
        self._lock = threading.Lock()

    def get_or_build(self, cid: str, table: str, colname: str, sf: float,
                     n_rows: int, pad: int, as_i32: bool,
                     zone_rows: int = DEFAULT_ZONE_ROWS,
                     encodings: bool = True) -> Optional[ResidentEntry]:
        with self._lock:
            return self._get_or_build(cid, table, colname, sf, n_rows, pad,
                                      as_i32, zone_rows, encodings)

    def _get_or_build(self, cid, table, colname, sf, n_rows, pad, as_i32,
                      zone_rows, encodings) -> Optional[ResidentEntry]:
        key = (cid, table, colname, float(sf), bool(as_i32))
        ent = self.entries.get(key)
        if ent is not None:
            if ent.pad >= pad and ent.zones.zone_rows <= zone_rows:
                self.entries.move_to_end(key)
                STORAGE_METRICS.incr("cache_hits")
                return ent
            # built under a smaller batch capacity or coarser zones
            self._evict(key)
        STORAGE_METRICS.incr("cache_misses")
        itemsize = 4 if as_i32 else 8
        if (n_rows + pad) * itemsize > self.max_column_bytes:
            STORAGE_METRICS.incr("build_rejected")
            return None
        arr = _build_full(cid, table, colname, sf, n_rows, pad, as_i32,
                          self.device)
        from ..connectors import device_gen
        hint = device_gen.encoding_hint(cid, table, colname)
        host = (arr.cpu().numpy()  # lint: allow-host-sync
                if n_rows <= HOST_STATS_ROWS else None)
        col = encode_column(arr, n_rows, encodings=encodings, hint=hint,
                            host=host)
        zones = build_zone_maps(arr, n_rows, zone_rows, host=host)
        del arr, host
        ent = ResidentEntry(col, zones, pad)
        while not self.pool.try_reserve(ent.nbytes):
            if not self.entries:
                STORAGE_METRICS.incr("build_rejected")
                return None
            self._evict(next(iter(self.entries)))
        self.entries[key] = ent
        STORAGE_METRICS.incr("columns_built")
        STORAGE_METRICS.incr("encoded_bytes", ent.nbytes)
        STORAGE_METRICS.incr("plain_bytes", col.logical_nbytes)
        STORAGE_METRICS["resident_bytes"] = self.pool.reserved
        return ent

    def _evict(self, key: tuple) -> None:
        ent = self.entries.pop(key)
        self.pool.free(ent.nbytes)
        STORAGE_METRICS.incr("evictions")
        STORAGE_METRICS["resident_bytes"] = self.pool.reserved

    def clear(self) -> None:
        with self._lock:
            for key in list(self.entries):
                self.pool.free(self.entries.pop(key).nbytes)
            STORAGE_METRICS["resident_bytes"] = self.pool.reserved


def _build_full(cid: str, table: str, colname: str, sf: float,
                n_rows: int, pad: int, as_i32: bool, device):
    """Generate one whole column on `device` in pow2 chunks (at most 4M
    rows each), zero tail padding appended so chunk slices never run off
    the table edge."""
    from ..connectors import device_gen
    chunk = 1 << max(10, min(22, (max(n_rows, 1) - 1).bit_length()))
    parts = []
    for p in range(0, n_rows, chunk):
        idx = p + torch.arange(chunk, dtype=torch.int64, device=device)
        v = device_gen.column(cid, table, colname, sf, idx)
        if as_i32 and v.dtype == torch.int64:
            v = v.to(torch.int32)
        parts.append(v)
    arr = torch.cat(parts)[:n_rows]
    return torch.cat([arr, torch.zeros(pad, dtype=arr.dtype, device=device)])


_STORES: Dict[tuple, ResidentStore] = {}
_STORES_LOCK = threading.Lock()


def get_store(budget: Optional[int] = DEFAULT_STORAGE_BUDGET,
              max_column_bytes: int = DEFAULT_MAX_COLUMN_BYTES,
              device="cpu") -> ResidentStore:
    key = (str(torch.device(device)), budget, max_column_bytes)
    with _STORES_LOCK:
        st = _STORES.get(key)
        if st is None:
            st = _STORES[key] = ResidentStore(budget, max_column_bytes,
                                              device)
        return st
