"""Device-side columnar batch model over torch tensors.

A Batch is a fixed-capacity set of device tensors plus a row-validity
mask (the counterpart of presto_tpu/exec/batch.py).  Columns:

  values      tensor of the logical dtype (int8/16/32/64, float64, bool)
  nulls       optional bool tensor (True == SQL NULL)
  dictionary  optional tuple of python strings: `values` are int32 codes
              into it (host metadata; strings never reach the device)
  lazy        optional (connector, table, column, sf): late
              materialization of an open-domain string column -- `values`
              are the table's global row ids, and the strings are
              generated at the output boundary (batch_to_page) for live
              rows only
  lengths     ARRAY columns: `values` is a padded (capacity, W) element
              matrix and `lengths` (capacity,) int32 each row's live
              element count (the ragged ArrayBlock exists only at the
              page boundary)

The mask subsumes selection (filters clear bits) and padding.  Every
tensor of a batch lives on one device, the one its producer was given.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.block import (ArrayBlock, DictionaryBlock, FixedWidthBlock,
                            Int128Block, VariableWidthBlock, decode_to_flat)
from ..common.page import Page
from ..common.types import (ArrayType, BooleanType, DateType, DecimalType,
                            DoubleType, IntegerType, RealType, Type,
                            VarcharType, CharType)


class Column:
    def __init__(self, values, nulls=None,
                 dictionary: Optional[Tuple[str, ...]] = None,
                 lazy: Optional[Tuple] = None, lengths=None):
        self.values = values
        self.nulls = nulls
        self.dictionary = dictionary
        self.lazy = lazy
        self.lengths = lengths

    def null_mask(self):
        if self.nulls is None:
            return torch.zeros(self.values.shape[:1], dtype=torch.bool,
                               device=self.values.device)
        return self.nulls

    def gather(self, idx) -> "Column":
        """Row gather preserving dictionary / lazy metadata."""
        return Column(self.values[idx],
                      None if self.nulls is None else self.nulls[idx],
                      self.dictionary, self.lazy,
                      None if self.lengths is None else self.lengths[idx])

    def slice_rows(self, lo: int, hi: int) -> "Column":
        return Column(self.values[lo:hi],
                      None if self.nulls is None else self.nulls[lo:hi],
                      self.dictionary, self.lazy,
                      None if self.lengths is None
                      else self.lengths[lo:hi])

    def __repr__(self):
        d = f", dict[{len(self.dictionary)}]" if self.dictionary else ""
        return f"Column({self.values.dtype}{tuple(self.values.shape)}{d})"


class Batch:
    def __init__(self, columns: Dict[str, Column], mask):
        self.columns = columns
        self.mask = mask
        # bound-parameter vector (one int64 tensor, sql/canonical.py
        # device_params) read by Lowering for BoundParameterExpression
        self.params = None

    @property
    def capacity(self) -> int:
        return int(self.mask.shape[0])

    @property
    def device(self):
        return self.mask.device

    def column(self, name: str) -> Column:
        return self.columns[name]

    def with_mask(self, mask) -> "Batch":
        return Batch(self.columns, mask)

    def with_columns(self, new: Dict[str, Column]) -> "Batch":
        cols = dict(self.columns)
        cols.update(new)
        return Batch(cols, self.mask)

    def select(self, names) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.mask)

    def with_params(self, params) -> "Batch":
        out = Batch(self.columns, self.mask)
        out.params = params
        return out

    def __repr__(self):
        return f"Batch({list(self.columns)}, capacity={self.capacity})"


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def _logical_np(typ: Type, values: np.ndarray) -> np.ndarray:
    """Storage-dtype numpy array -> logical-dtype numpy array."""
    if isinstance(typ, DoubleType):
        return values.view(np.float64) if values.dtype != np.float64 else values
    if isinstance(typ, RealType):
        # REAL travels as float32 bits in an INT_ARRAY
        if values.dtype == np.float64:
            return values.astype(np.float32)
        return values if values.dtype == np.float32 \
            else values.view(np.float32)
    if isinstance(typ, BooleanType):
        return values.astype(bool)
    return values


def _host_array(typ: Type, block: ArrayBlock):
    """(element matrix, nulls, lengths) of a ragged ArrayBlock: a (rows, W)
    numpy matrix, W the next power of two at or above the longest array
    (reference presto_tpu/exec/batch.py block_to_column)."""
    etyp = typ.element if isinstance(typ, ArrayType) else typ
    inner = decode_to_flat(block.elements)
    if not isinstance(inner, FixedWidthBlock):
        raise NotImplementedError("nested/varchar array elements")
    flat = _logical_np(etyp, inner.values)
    offs = block.offsets.astype(np.int64)
    lens = offs[1:] - offs[:-1]
    W = max(1, 1 << int(max(1, lens.max(initial=1)) - 1).bit_length())
    mat = np.zeros((len(lens), W), dtype=flat.dtype)
    live = np.arange(W)[None, :] < lens[:, None]
    base = int(offs[0])                 # offsets are contiguous
    mat[live] = flat[base:base + int(lens.sum())]
    return mat, block.nulls, lens.astype(np.int32)


def _host_column(typ: Type, block):
    """(values, nulls, dictionary, lengths) of a host block as the device
    column holds them: the logical values as numpy (a string block's int32
    codes into its dictionary, a long decimal narrowed to int64, an
    array's padded element matrix), the NULL mask or None, the dictionary
    tuple or None, an array's lengths or None."""
    if isinstance(block, DictionaryBlock):
        flat = decode_to_flat(block.dictionary)
        if isinstance(flat, VariableWidthBlock):
            nulls = (flat.null_mask()[block.ids] if flat.nulls is not None
                     else None)
            return block.ids, nulls, tuple(flat.to_pylist()), None
    block = decode_to_flat(block)
    if isinstance(block, ArrayBlock):
        mat, nulls, lens = _host_array(typ, block)
        return mat, nulls, None, lens
    if isinstance(block, VariableWidthBlock):
        # dictionary-encode on the host: the device sees int32 codes
        strings = block.to_pylist()
        uniq = sorted({s for s in strings if s is not None})
        index = {s: i for i, s in enumerate(uniq)}
        codes = np.array([0 if s is None else index[s] for s in strings],
                         dtype=np.int32)
        nm = np.array([s is None for s in strings], dtype=bool)
        return codes, (nm if nm.any() else None), tuple(uniq), None
    if isinstance(block, Int128Block):
        # long decimals are narrowed to int64 on the device (batch_to_page
        # widens them on the way back out)
        narrow = _int128_to_int64(block)
        if narrow is None:
            ints = block.to_pylist()
            narrow = (np.array([0 if v is None else v for v in ints],
                               dtype=np.int64),
                      np.array([v is None for v in ints], dtype=bool))
        vals, nm = narrow
        return vals, (nm if nm.any() else None), None, None
    if not isinstance(block, FixedWidthBlock):
        raise NotImplementedError(
            f"device column from {type(block).__name__} not ported yet")
    return _logical_np(typ, block.values), block.nulls, None, None


def _device_column(values, nulls, dictionary, lazy, capacity: int,
                   device, lengths=None) -> Column:
    """Host arrays padded to `capacity` rows as a device column (an
    array's element matrix keeps its width)."""
    padded = np.zeros((capacity,) + values.shape[1:], dtype=values.dtype)
    padded[:len(values)] = values
    dev_nulls = dev_lengths = None
    if nulls is not None:
        nm = np.zeros(capacity, dtype=bool)
        nm[:len(nulls)] = nulls
        dev_nulls = torch.from_numpy(nm).to(device)
    if lengths is not None:
        ln = np.zeros(capacity, dtype=np.int32)
        ln[:len(lengths)] = lengths
        dev_lengths = torch.from_numpy(ln).to(device)
    return Column(torch.from_numpy(padded).to(device), dev_nulls,
                  dictionary, lazy, dev_lengths)


def block_to_column(typ: Type, block, capacity: int, device) -> Column:
    """Host block -> padded device column."""
    values, nulls, dictionary, lengths = _host_column(typ, block)
    return _device_column(values, nulls, dictionary, None, capacity, device,
                          lengths)


_SIGN = np.uint64(1 << 63)


def _int128_from_int64(values: np.ndarray, nulls) -> Int128Block:
    """int64 values as the long-decimal block Int128Block.from_ints builds
    from them (sign-magnitude: word 0 the low 64 bits of |value|, word 1
    the sign bit), without a Python int per row; NULL rows are zero."""
    v = values.astype(np.int64)
    bits = v.view(np.uint64)
    neg = v < 0
    out = np.zeros((len(v), 2), dtype=np.uint64)
    # |v| in uint64 (two's complement negation, exact for INT64_MIN)
    out[:, 0] = np.where(neg, ~bits + np.uint64(1), bits)
    out[:, 1] = np.where(neg, _SIGN, np.uint64(0))
    if nulls is not None:
        out[nulls] = 0
    return Int128Block(out.view(np.int64),
                       nulls if (nulls is not None and nulls.any())
                       else None)


def _int128_to_int64(block: Int128Block):
    """(int64 values, NULL mask) of a long-decimal block whose values fit
    int64, vectorized; None when one does not (the caller's per-row path
    raises on it)."""
    words = block.values.view(np.uint64)
    lo, hi = words[:, 0], words[:, 1]
    nm = block.null_mask()
    live = ~nm
    neg = (hi & _SIGN) != 0
    if ((hi & ~_SIGN)[live] != 0).any() \
            or (lo[live & ~neg] >= _SIGN).any() \
            or (lo[live & neg] > _SIGN).any():
        return None
    vals = np.where(neg, ~lo + np.uint64(1), lo).view(np.int64)
    return np.where(live, vals, 0), nm


def page_to_batch(page: Page, names, types, capacity: int,
                  device="cpu") -> Batch:
    """Host page -> device batch (pads to capacity)."""
    if page.position_count > capacity:
        raise ValueError(
            f"page of {page.position_count} rows > capacity {capacity}")
    cols = {name: block_to_column(typ, block, capacity, device)
            for name, typ, block in zip(names, types, page.blocks)}
    mask = torch.zeros(capacity, dtype=torch.bool, device=device)
    mask[:page.position_count] = True
    return Batch(cols, mask)


class LazyStringBlock(VariableWidthBlock):
    """A late-materialized string column of a page: the live rows' row ids
    and the column's lazy tag, standing for the VariableWidthBlock of
    their strings.  The bytes (offsets, data, to_pylist, slice_at) are
    generated at the first read, so every reader sees the block the
    strings make; take() and row counts need none, and an exchange
    consumer whose pages all carry the column this way rebuilds the lazy
    column from the row ids (pages_to_batches) without generating a
    string."""

    def __init__(self, row_ids: np.ndarray, lazy: Tuple,
                 nulls: Optional[np.ndarray] = None):
        self.row_ids = row_ids
        self.lazy = lazy
        self.position_count = len(row_ids)
        self.nulls = nulls if (nulls is not None and nulls.any()) else None
        self._block: Optional[VariableWidthBlock] = None

    def _materialized(self) -> VariableWidthBlock:
        if self._block is None:
            from ..connectors import catalog
            cid, table, column, sf = self.lazy
            strings = catalog.generate_values_at(
                table, column, sf, self.row_ids.astype(np.int64), cid)
            if self.nulls is not None:
                strings = [None if n else s
                           for s, n in zip(strings, self.nulls)]
            self._block = VariableWidthBlock.from_strings(strings)
        return self._block

    @property
    def offsets(self) -> np.ndarray:
        return self._materialized().offsets

    @property
    def data(self) -> np.ndarray:
        return self._materialized().data

    def take(self, positions) -> "LazyStringBlock":
        positions = np.asarray(positions)
        return LazyStringBlock(
            self.row_ids[positions], self.lazy,
            None if self.nulls is None else self.nulls[positions])


# the dictionary blocks batch_to_page built, by the dictionary tuple's
# identity: every page of a column shares its dictionary object, so its
# entries are encoded once, not once per page
_DICT_BLOCKS: "Dict[Tuple[int, bool], tuple]" = {}
_DICT_BLOCKS_MAX = 64
_DICT_BLOCKS_LOCK = threading.Lock()


def _dictionary_block(dictionary: Tuple[str, ...],
                      with_null: bool) -> VariableWidthBlock:
    """The entries of a column's dictionary as a VariableWidthBlock (a None
    entry appended when `with_null`), built once per dictionary object."""
    key = (id(dictionary), with_null)
    with _DICT_BLOCKS_LOCK:
        ent = _DICT_BLOCKS.get(key)
    if ent is not None and ent[0] is dictionary:
        return ent[1]
    entries = list(dictionary) + ([None] if with_null else [])
    block = VariableWidthBlock.from_strings(entries)
    with _DICT_BLOCKS_LOCK:
        if len(_DICT_BLOCKS) >= _DICT_BLOCKS_MAX:
            _DICT_BLOCKS.pop(next(iter(_DICT_BLOCKS)))
        _DICT_BLOCKS[key] = (dictionary, block)
    return block


def _element_block(etyp: Type, flat: np.ndarray) -> FixedWidthBlock:
    """Flat array-element values -> a storage-dtype FixedWidthBlock (the
    same logical->storage rules as scalar columns in batch_to_page)."""
    if isinstance(etyp, BooleanType):
        flat = flat.astype(np.int8)
    elif isinstance(etyp, RealType):
        flat = flat.astype(np.float32).view(np.int32)   # REAL's wire bits
    elif isinstance(etyp, DoubleType):
        pass                        # float bits pass through
    elif flat.dtype not in (np.int8, np.int16, np.int32, np.int64):
        flat = flat.astype(etyp.np_dtype)
    if isinstance(etyp, (IntegerType, DateType)):
        flat = flat.astype(np.int32)
    return FixedWidthBlock(flat)


def batch_to_page(batch: Batch, names, types) -> Page:
    """Device batch -> host page (drops masked-out rows).  One host copy
    per tensor, taken after the live rows are selected on the device."""
    keep = torch.nonzero(batch.mask).flatten()
    if keep.numel() == 0:
        from ..common.block import block_from_values
        return Page([block_from_values(t, []) for t in types], 0)
    blocks = []
    for name, typ in zip(names, types):
        col = batch.columns[name]
        values = col.values[keep].cpu().numpy()  # lint: allow-host-sync
        nulls = None if col.nulls is None else (
            col.nulls[keep].cpu().numpy())  # lint: allow-host-sync
        if col.lazy is not None:
            # late-materialized strings: generated for the live rows only,
            # when a reader first needs their bytes
            blocks.append(LazyStringBlock(values, col.lazy, nulls))
            continue
        if col.dictionary is not None:
            ids = values.astype(np.int32)
            with_null = nulls is not None and bool(nulls.any())
            if with_null:
                # DictionaryBlock carries nulls via its dictionary entries:
                # route NULL rows to an appended None entry
                ids[nulls] = len(col.dictionary)
            blocks.append(DictionaryBlock(
                ids, _dictionary_block(col.dictionary, with_null)))
            continue
        if col.lengths is not None:
            # ARRAY column: (rows, W) padded element matrix + live lengths
            # -> ragged ArrayBlock (offsets into a flat element block)
            lens = col.lengths[keep].cpu(  # lint: allow-host-sync
            ).numpy().astype(np.int64)
            W = values.shape[1] if values.ndim > 1 else 0
            lens = np.clip(lens, 0, W)
            if nulls is not None:
                lens = np.where(nulls, 0, lens)
            elem2d = values.reshape(len(lens), W)
            flat = elem2d[np.arange(W)[None, :] < lens[:, None]]
            offsets = np.zeros(len(lens) + 1, dtype=np.int32)
            np.cumsum(lens, out=offsets[1:])
            etyp = typ.element if isinstance(typ, ArrayType) else typ
            blocks.append(ArrayBlock(offsets, _element_block(etyp, flat),
                                     nulls))
            continue
        if isinstance(typ, (VarcharType, CharType)):
            raise NotImplementedError("varchar column without dictionary")
        if isinstance(typ, DecimalType) and not typ.is_short:
            # the device accumulates long decimals in int64; widen here
            blocks.append(_int128_from_int64(values, nulls))
            continue
        if isinstance(typ, BooleanType):
            values = values.astype(np.int8)
        elif isinstance(typ, RealType):
            # float32 bits in an INT_ARRAY, as the wire carries REAL
            values = values.astype(np.float32).view(np.int32)
        elif isinstance(typ, DoubleType):
            pass  # float bits pass through FixedWidthBlock
        elif values.dtype not in (np.int8, np.int16, np.int32, np.int64):
            values = values.astype(typ.np_dtype)
        if isinstance(typ, (IntegerType, DateType)):
            values = values.astype(np.int32)
        blocks.append(FixedWidthBlock(values, nulls))
    return Page(blocks, int(keep.numel()))


def _string_keys(block: VariableWidthBlock, width: int) -> np.ndarray:
    """The block's strings as one numpy bytes array of itemsize width + 4,
    built from its offsets and data without a Python object per row: a
    row's UTF-8 bytes, NUL-padded to `width`, then its byte length
    big-endian.  Bytes arrays compare byte by byte, so the keys sort as
    Python sorts the strings (UTF-8 byte order is code-point order, and a
    string that ends in NUL bytes follows its stripped prefix by its
    length), and two keys are equal only for equal strings."""
    offsets = block.offsets.astype(np.int64)
    lo, hi = int(offsets[0]), int(offsets[-1])
    lengths = offsets[1:] - offsets[:-1]
    n = len(lengths)
    mat = np.zeros((n, width + 4), dtype=np.uint8)
    if hi > lo:
        rows = np.repeat(np.arange(n), lengths)
        pos = np.arange(hi - lo) - np.repeat(offsets[:-1] - lo, lengths)
        mat[rows, pos] = block.data[lo:hi]
    mat[:, width:] = lengths.astype(">u4").view(np.uint8).reshape(n, 4)
    return mat.view(f"S{width + 4}").reshape(n)


def _string_entries(block, memo: dict):
    """(entries, entry_nulls, ids) of a string block: its distinct storage
    entries as a flat VariableWidthBlock and each row's entry index (a
    dictionary block's dictionary and ids, a flat block's rows).  A
    dictionary shared by several pages is decoded once (`memo`, by the
    dictionary block's identity)."""
    if isinstance(block, DictionaryBlock):
        ent = memo.get(id(block.dictionary))
        if ent is not None and ent[0] is block.dictionary:
            return ent[1], ent[2], block.ids
        inner = decode_to_flat(block.dictionary)
        ids = block.ids
    else:
        inner = decode_to_flat(block)
        ids = None
    if not isinstance(inner, VariableWidthBlock):
        raise TypeError(f"a string column holds a "
                        f"{type(inner).__name__}")
    if ids is None:
        return inner, inner.null_mask(), np.arange(inner.position_count)
    memo[id(block.dictionary)] = (block.dictionary, inner,
                                  inner.null_mask())
    return inner, inner.null_mask(), ids


def _union_codes(pages, i: int):
    """One string column's union dictionary over every page and each
    page's int32 codes and NULL mask into it, vectorized: the live
    non-NULL entries of every page are sorted and deduplicated together
    (np.unique over _string_keys, whose order is that of Python's
    sorted()), and each page's entries are located in the union by binary
    search."""
    used, memo = [], {}
    for page in pages:
        used.append(_string_entries(page.blocks[i], memo))
    width = max([1] + [int(np.diff(inner.offsets).max())
                       for inner, _n, _ids in used
                       if inner.position_count])
    keyed, parts = {}, []
    for inner, enulls, ids in used:
        # a shared dictionary's entries are keyed and located once
        if id(inner) not in keyed:
            keyed[id(inner)] = (inner, _string_keys(inner, width))
        live = np.unique(ids[~enulls[ids]])
        parts.append(keyed[id(inner)][1][live])
    union = (np.unique(np.concatenate(parts)) if parts
             else np.zeros(0, dtype=f"S{width + 4}"))
    lengths = union.view(np.uint8).reshape(-1, width + 4)[:, width:] \
        .copy().view(">u4").ravel()
    # bytes items drop trailing NULs, which lie past the string's length
    # (the length's last byte, or padding) unless the string is empty
    strings = tuple(b[:n].decode("utf-8")
                    for b, n in zip(union.tolist(), lengths.tolist()))
    located = {k: np.searchsorted(union, keys).astype(np.int32)
               for k, (_inner, keys) in keyed.items()}
    out = []
    for inner, enulls, ids in used:
        codes = located[id(inner)][ids]
        nulls = enulls[ids]
        codes[nulls] = 0
        out.append((codes, nulls))
    return strings, out


def _lazy_column(pages, i: int) -> bool:
    """Whether every page holds column i as row ids of one lazy column."""
    blocks = [p.blocks[i] for p in pages]
    return all(isinstance(b, LazyStringBlock) for b in blocks) \
        and len({b.lazy for b in blocks}) == 1


def pages_to_batches(pages, names, types, capacity: int, device="cpu",
                     pack_rows: Optional[int] = None):
    """Host pages (exchange input) -> device batches with STABLE
    dictionaries.

    Pages arriving from different producer tasks carry independent
    dictionaries; consumers (aggregation tables, concatenation for joins)
    need one dictionary per column across all batches, so string columns
    are remapped onto the sorted union of the strings the pages hold (the
    reference's codes and dictionary, computed by _union_codes).  A
    column that every page carries as row ids of one late-materialized
    column (LazyStringBlock) stays that lazy column.  Consecutive pages
    are packed into batches of up to `pack_rows` rows (`capacity` when
    not given; a page larger than that is split), so a stream of small
    pages -- a filtered producer's output split per consumer -- costs
    its consumer few batches.  A batch's capacity is `capacity`, or the
    power of two its rows need up to `pack_rows`."""
    pack_rows = max(capacity, pack_rows or capacity)
    string_cols = [i for i, t in enumerate(types)
                   if isinstance(t, (VarcharType, CharType))]
    lazy, unions = set(), {}
    if string_cols:
        pages = [p for p in pages if p.position_count]
        if not pages:
            return
        lazy = {i for i in string_cols if _lazy_column(pages, i)}
        unions = {i: _union_codes(pages, i)
                  for i in string_cols if i not in lazy}

    def host_columns(pi, page):
        """Each column of a page as (values, nulls, dictionary, lazy)."""
        cols = []
        for i, typ in enumerate(types):
            block = page.blocks[i]
            if i in lazy:
                cols.append((block.row_ids, block.nulls, None, block.lazy,
                             None))
            elif i in unions:
                uniq, per_page = unions[i]
                codes, nulls = per_page[pi]
                cols.append((codes, nulls if nulls.any() else None, uniq,
                             None, None))
            else:
                v, nl, d, ln = _host_column(typ, block)
                cols.append((v, nl, d, None, ln))
        return cols

    def flush(pending, n):
        cap = min(pack_rows, max(capacity, 1 << (n - 1).bit_length()))
        mask = torch.zeros(cap, dtype=torch.bool, device=device)
        mask[:n] = True
        cols = {}
        for i, name in enumerate(names):
            parts = [(c[i], lo, hi) for c, lo, hi in pending]
            lengths = None
            if parts[0][0][4] is not None:
                # an ARRAY column: each page's matrix padded to the widest
                W = max(c[0].shape[1] for c, _lo, _hi in parts)
                values = np.concatenate([
                    np.pad(c[0][lo:hi], ((0, 0), (0, W - c[0].shape[1])))
                    for c, lo, hi in parts])
                lengths = np.concatenate([c[4][lo:hi]
                                          for c, lo, hi in parts])
            else:
                values = np.concatenate([c[0][lo:hi]
                                         for c, lo, hi in parts])
            nulls = None
            if any(c[1] is not None for c, _lo, _hi in parts):
                nulls = np.concatenate([
                    c[1][lo:hi] if c[1] is not None
                    else np.zeros(hi - lo, dtype=bool)
                    for c, lo, hi in parts])
                if not nulls.any():
                    nulls = None
            _v, _n, dictionary, lz, _l = parts[0][0]
            cols[name] = _device_column(values, nulls, dictionary, lz,
                                        cap, device, lengths)
        return Batch(cols, mask)

    pending, filled = [], 0
    for pi, page in enumerate(pages):
        n = page.position_count
        if not n:
            continue
        cols, lo = host_columns(pi, page), 0
        while lo < n:
            take = min(pack_rows - filled, n - lo)
            pending.append((cols, lo, lo + take))
            filled += take
            lo += take
            if filled == pack_rows:
                yield flush(pending, filled)
                pending, filled = [], 0
    if filled:
        yield flush(pending, filled)
