"""Lightweight columnar encodings for device-resident table columns.

A `ResidentColumn` is one whole-table column materialized once into
device memory in an encoded physical form and decoded per row inside the
fused scan kernel -- the port of presto_tpu/storage/encodings.py with
the same selection rules, thresholds and physical layouts, so both
packages hold the same encoded bytes for the same data:

- ``plain``  -- the padded device array as-is.
- ``dict``   -- sorted distinct values + per-row codes (int8 when the
  cardinality fits in 7 bits, else int16).  Decode is ``values[codes]``.
- ``rle``    -- run values + run start offsets (with a sentinel run at
  n_rows).  Decode is ``values[searchsorted(starts, row, right) - 1]``.

Zone maps (per-zone min/max/null-count) are built from the exact values
and brought to the host once, so query-time pruning is host numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# dictionary codes wider than int16 would erase most of the byte win
DICT_MAX_NDV = 1 << 15
# cheap cardinality probe before paying a full-column unique sort
DICT_PROBE_ROWS = 1 << 18
# without a connector hint, RLE must compress >= this factor
RLE_MIN_COMPRESSION = 16.0
# with a connector "rle" hint (known-monotone layout), accept >= 2x
RLE_HINT_COMPRESSION = 2.0


class ResidentColumn:
    """One whole-table encoded column: `arrays` are device tensors."""

    def __init__(self, kind: str, arrays: Tuple, n_rows: int):
        self.kind = kind          # "plain" | "dict" | "rle"
        self.arrays = tuple(arrays)
        self.n_rows = int(n_rows)

    @property
    def device(self):
        return self.arrays[0].device

    def decode_rows(self, idx):
        """Logical values at absolute row indices `idx` (int64 tensor)."""
        if self.kind == "plain":
            return self.arrays[0].index_select(0, idx)
        if self.kind == "dict":
            codes, values = self.arrays
            return values.index_select(
                0, codes.index_select(0, idx).to(torch.int64))
        run_values, run_starts = self.arrays
        ri = torch.searchsorted(run_starts, idx, right=True) - 1
        ri = ri.clamp(0, run_values.shape[0] - 1)
        return run_values.index_select(0, ri)

    def slice_decode(self, pos: int, cap: int):
        """Decode rows [pos, pos+cap) to logical values.  Arrays are
        tail-padded past n_rows at build time."""
        if self.kind == "plain":
            return self.arrays[0][pos:pos + cap]
        if self.kind == "dict":
            codes, values = self.arrays
            return values[codes[pos:pos + cap].to(torch.int64)]
        idx = pos + torch.arange(cap, dtype=torch.int64, device=self.device)
        return self.decode_rows(idx)

    def decode_full(self):
        """The full padded logical array (tests / zone-map building)."""
        if self.kind == "plain":
            return self.arrays[0]
        if self.kind == "dict":
            codes, values = self.arrays
            return values[codes.to(torch.int64)]
        return self.slice_decode(0, self.n_rows)

    @property
    def nbytes(self) -> int:
        """Resident (encoded) device bytes."""
        return int(sum(a.numel() * a.element_size() for a in self.arrays))

    @property
    def logical_nbytes(self) -> int:
        """Bytes a plain encoding of the same column would hold."""
        if self.kind == "plain":
            return self.nbytes
        if self.kind == "dict":
            codes, values = self.arrays
            return int(codes.shape[0] * values.element_size())
        return self.n_rows * self.arrays[0].element_size()

    @property
    def dtype(self):
        return self.arrays[1 if self.kind == "dict" else 0].dtype

    def __repr__(self):
        return (f"ResidentColumn({self.kind}, rows={self.n_rows}, "
                f"bytes={self.nbytes})")


# ---------------------------------------------------------------------------
# encoder selection
# ---------------------------------------------------------------------------

def encode_column(arr, n_rows: int, encodings: bool = True,
                  hint: Optional[str] = None,
                  host: Optional[np.ndarray] = None) -> ResidentColumn:
    """Pick an encoding for a fully built padded device array `arr`
    (n_rows logical rows plus zero tail padding).  With `host` (the same
    padded column as numpy) selection and encoding run in numpy and only
    the encoded arrays go to the device."""
    if not encodings or n_rows < 2 or hint == "plain":
        return ResidentColumn("plain", (arr,), n_rows)
    if host is not None:
        return _encode_column_host(arr, host, n_rows, hint)
    device = arr.device
    body = arr[:n_rows]
    itemsize = arr.element_size()

    # --- RLE: runs of equal adjacent values ------------------------------
    changes = body[1:] != body[:-1]
    nruns = 1 + int(changes.sum())
    plain_bytes = n_rows * itemsize
    rle_bytes = nruns * (itemsize + 8)
    want = RLE_HINT_COMPRESSION if hint == "rle" else RLE_MIN_COMPRESSION
    if rle_bytes * want <= plain_bytes:
        change_mask = torch.cat(
            [torch.ones(1, dtype=torch.bool, device=device), changes])
        starts = torch.nonzero(change_mask).flatten()
        run_values = torch.cat([body[starts],
                                torch.zeros(1, dtype=body.dtype,
                                            device=device)])
        run_starts = torch.cat([starts, torch.tensor(
            [n_rows], dtype=torch.int64, device=device)])
        return ResidentColumn("rle", (run_values, run_starts), n_rows)

    # --- dictionary: low-cardinality columns ----------------------------
    probe = torch.unique(body[:DICT_PROBE_ROWS])
    if hint == "dict" or probe.shape[0] <= DICT_MAX_NDV:
        values = torch.unique(body)
        ndv = int(values.shape[0])
        if ndv <= DICT_MAX_NDV:
            code_dtype = torch.int8 if ndv <= 127 else torch.int16
            code_size = 1 if ndv <= 127 else 2
            dict_bytes = arr.shape[0] * code_size + ndv * itemsize
            # the values table is resident too
            if code_size < itemsize and dict_bytes < plain_bytes:
                codes = torch.searchsorted(values, arr).clamp(
                    0, ndv - 1).to(code_dtype)
                return ResidentColumn("dict", (codes, values), n_rows)
    return ResidentColumn("plain", (arr,), n_rows)


def _encode_column_host(arr, host: np.ndarray, n_rows: int,
                        hint: Optional[str]) -> ResidentColumn:
    """Numpy twin of the device selection path, same thresholds and
    physical layout; only the encoded arrays go back to the device."""
    device = arr.device
    body = host[:n_rows]
    itemsize = body.dtype.itemsize
    changes = body[1:] != body[:-1]
    nruns = 1 + int(np.count_nonzero(changes))
    plain_bytes = n_rows * itemsize
    rle_bytes = nruns * (itemsize + 8)
    want = RLE_HINT_COMPRESSION if hint == "rle" else RLE_MIN_COMPRESSION
    if rle_bytes * want <= plain_bytes:
        starts = np.flatnonzero(
            np.concatenate([np.ones(1, dtype=bool), changes]))
        run_values = np.concatenate([body[starts],
                                     np.zeros(1, dtype=body.dtype)])
        run_starts = np.concatenate([starts, [n_rows]]).astype(np.int64)
        return ResidentColumn("rle", (torch.from_numpy(run_values).to(device),
                                      torch.from_numpy(run_starts).to(device)),
                              n_rows)
    values_h = np.unique(body[:DICT_PROBE_ROWS])
    if hint == "dict" or values_h.shape[0] <= DICT_MAX_NDV:
        values_h = np.unique(body)
        ndv = int(values_h.shape[0])
        if ndv <= DICT_MAX_NDV:
            code_dtype = np.int8 if ndv <= 127 else np.int16
            dict_bytes = (host.shape[0] * np.dtype(code_dtype).itemsize
                          + ndv * itemsize)
            if np.dtype(code_dtype).itemsize < itemsize \
                    and dict_bytes < plain_bytes:
                codes_h = np.clip(np.searchsorted(values_h, host), 0,
                                  ndv - 1).astype(code_dtype)
                return ResidentColumn(
                    "dict", (torch.from_numpy(codes_h).to(device),
                             torch.from_numpy(values_h).to(device)), n_rows)
    return ResidentColumn("plain", (arr,), n_rows)


# ---------------------------------------------------------------------------
# zone maps
# ---------------------------------------------------------------------------

class ZoneMaps:
    """Host-side per-zone min/max/null-count at a fixed row granularity,
    consulted by pushdown.prune_chunks with pure numpy."""

    __slots__ = ("zmin", "zmax", "null_count", "zone_rows")

    def __init__(self, zmin: np.ndarray, zmax: np.ndarray,
                 null_count: np.ndarray, zone_rows: int):
        self.zmin = zmin
        self.zmax = zmax
        self.null_count = null_count
        self.zone_rows = int(zone_rows)

    def chunk_bounds(self, pos: int, count: int):
        """Aggregate (min, max) over the zones covering [pos, pos+count)."""
        z0 = pos // self.zone_rows
        z1 = (pos + count - 1) // self.zone_rows
        z1 = min(z1, len(self.zmin) - 1)
        if z0 > z1:
            return None
        return self.zmin[z0:z1 + 1].min(), self.zmax[z0:z1 + 1].max()


def _identities_np(dtype: np.dtype):
    if np.issubdtype(dtype, np.floating):
        return np.inf, -np.inf
    if dtype == np.bool_:
        return True, False
    info = np.iinfo(dtype)
    return info.max, info.min


def build_zone_maps(arr, n_rows: int, zone_rows: int, nulls=None,
                    host: Optional[np.ndarray] = None) -> ZoneMaps:
    """Reshape+reduce over the UNPADDED rows; the ragged last zone is
    padded with reduction identities so tail padding never leaks into a
    zone's min.  With `host` the reduce is pure numpy."""
    if host is not None and nulls is None:
        return _build_zone_maps_host(host, n_rows, zone_rows)
    body = arr[:n_rows]
    nz = -(-n_rows // zone_rows)
    pad = nz * zone_rows - n_rows
    np_dtype = torch.empty(  # lint: allow-host-sync
        0, dtype=body.dtype).numpy().dtype
    ident_min, ident_max = _identities_np(np_dtype)

    def padded(ident):
        if not pad:
            return body
        return torch.cat([body, torch.full((pad,), ident, dtype=body.dtype,
                                           device=body.device)])
    zmin = padded(ident_min).reshape(nz, zone_rows).amin(dim=1)
    zmax = padded(ident_max).reshape(nz, zone_rows).amax(dim=1)
    if nulls is not None:
        nbody = nulls[:n_rows]
        if pad:
            nbody = torch.cat([nbody, torch.zeros(pad, dtype=torch.bool,
                                                  device=nbody.device)])
        ncnt = nbody.reshape(nz, zone_rows).sum(  # lint: allow-host-sync
            dim=1).cpu().numpy()
    else:
        ncnt = np.zeros(nz, dtype=np.int32)
    lo, hi = zmin.cpu().numpy(), zmax.cpu().numpy()  # lint: allow-host-sync
    return ZoneMaps(lo, hi, ncnt, zone_rows)


def _build_zone_maps_host(host: np.ndarray, n_rows: int,
                          zone_rows: int) -> ZoneMaps:
    body = host[:n_rows]
    nz = -(-n_rows // zone_rows)
    pad = nz * zone_rows - n_rows
    ident_min, ident_max = _identities_np(body.dtype)
    pmin = np.concatenate(
        [body, np.full(pad, ident_min, dtype=body.dtype)]) if pad else body
    pmax = np.concatenate(
        [body, np.full(pad, ident_max, dtype=body.dtype)]) if pad else body
    return ZoneMaps(pmin.reshape(nz, zone_rows).min(axis=1),
                    pmax.reshape(nz, zone_rows).max(axis=1),
                    np.zeros(nz, dtype=np.int32), zone_rows)


# ---------------------------------------------------------------------------
# state carried across from the reference package
# ---------------------------------------------------------------------------

def resident_from_numpy(kind: str, arrays, zone_maps, n_rows: int,
                        device="cpu"):
    """A reference-package ResidentColumn's arrays (as numpy) and its zone
    maps (any object with zmin/zmax/null_count/zone_rows, or None) -> the
    port's (ResidentColumn, ZoneMaps or None) on `device`, so both
    packages compute on the same encoded state."""
    col = ResidentColumn(kind, tuple(torch.from_numpy(np.array(a)).to(device)
                                     for a in arrays), n_rows)
    zones = None
    if zone_maps is not None:
        zones = ZoneMaps(np.asarray(zone_maps.zmin),
                         np.asarray(zone_maps.zmax),
                         np.asarray(zone_maps.null_count),
                         zone_maps.zone_rows)
    return col, zones
