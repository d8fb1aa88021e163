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

The mask subsumes selection (filters clear bits) and padding.  Every
tensor of a batch lives on one device, the one its producer was given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.block import (DictionaryBlock, FixedWidthBlock, Int128Block,
                            VariableWidthBlock, decode_to_flat)
from ..common.page import Page
from ..common.types import (BooleanType, DateType, DecimalType, DoubleType,
                            IntegerType, RealType, Type, VarcharType, CharType)


class Column:
    def __init__(self, values, nulls=None,
                 dictionary: Optional[Tuple[str, ...]] = None,
                 lazy: Optional[Tuple] = None):
        self.values = values
        self.nulls = nulls
        self.dictionary = dictionary
        self.lazy = lazy

    def null_mask(self):
        if self.nulls is None:
            return torch.zeros(self.values.shape[:1], dtype=torch.bool,
                               device=self.values.device)
        return self.nulls

    def gather(self, idx) -> "Column":
        """Row gather preserving dictionary / lazy metadata."""
        return Column(self.values[idx],
                      None if self.nulls is None else self.nulls[idx],
                      self.dictionary, self.lazy)

    def slice_rows(self, lo: int, hi: int) -> "Column":
        return Column(self.values[lo:hi],
                      None if self.nulls is None else self.nulls[lo:hi],
                      self.dictionary, self.lazy)

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
    if isinstance(typ, BooleanType):
        return values.astype(bool)
    return values


def block_to_column(typ: Type, block, capacity: int, device) -> Column:
    """Host block -> padded device column."""
    if isinstance(typ, RealType):
        raise NotImplementedError("REAL columns are not ported yet")
    if isinstance(block, DictionaryBlock):
        flat = decode_to_flat(block.dictionary)
        if isinstance(flat, VariableWidthBlock):
            codes = np.zeros(capacity, dtype=np.int32)
            codes[:block.position_count] = block.ids
            nulls = None
            if flat.nulls is not None:
                nm = np.zeros(capacity, dtype=bool)
                nm[:block.position_count] = flat.null_mask()[block.ids]
                nulls = torch.from_numpy(nm).to(device)
            return Column(torch.from_numpy(codes).to(device), nulls,
                          tuple(flat.to_pylist()))
    block = decode_to_flat(block)
    if isinstance(block, VariableWidthBlock):
        # dictionary-encode on the host: the device sees int32 codes
        strings = block.to_pylist()
        uniq = sorted({s for s in strings if s is not None})
        index = {s: i for i, s in enumerate(uniq)}
        codes = np.zeros(capacity, dtype=np.int32)
        codes[:len(strings)] = [0 if s is None else index[s] for s in strings]
        nm = np.zeros(capacity, dtype=bool)
        nm[:len(strings)] = [s is None for s in strings]
        nulls = torch.from_numpy(nm).to(device) if nm.any() else None
        return Column(torch.from_numpy(codes).to(device), nulls, tuple(uniq))
    if isinstance(block, Int128Block):
        # long decimals are narrowed to int64 on the device (batch_to_page
        # widens them on the way back out)
        ints = block.to_pylist()
        vals = np.zeros(capacity, dtype=np.int64)
        nm = np.zeros(capacity, dtype=bool)
        vals[:len(ints)] = [0 if v is None else v for v in ints]
        nm[:len(ints)] = [v is None for v in ints]
        return Column(torch.from_numpy(vals).to(device),
                      torch.from_numpy(nm).to(device) if nm.any() else None)
    if not isinstance(block, FixedWidthBlock):
        raise NotImplementedError(
            f"device column from {type(block).__name__} not ported yet")
    logical = _logical_np(typ, block.values)
    padded = np.zeros(capacity, dtype=logical.dtype)
    padded[:len(logical)] = logical
    nulls = None
    if block.nulls is not None:
        nm = np.zeros(capacity, dtype=bool)
        nm[:block.position_count] = block.nulls
        nulls = torch.from_numpy(nm).to(device)
    return Column(torch.from_numpy(padded).to(device), nulls)


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
        values = col.values[keep].cpu().numpy()
        nulls = None if col.nulls is None else col.nulls[keep].cpu().numpy()
        if col.lazy is not None:
            # late-materialized strings: generated for the live rows only
            from ..connectors import catalog
            cid, table, column, sf = col.lazy
            strings = catalog.generate_values_at(table, column, sf,
                                                 values.astype(np.int64),
                                                 cid)
            if nulls is not None:
                strings = [None if n else s for s, n in zip(strings, nulls)]
            blocks.append(VariableWidthBlock.from_strings(strings))
            continue
        if col.dictionary is not None:
            ids = values.astype(np.int32)
            entries = list(col.dictionary)
            if nulls is not None and nulls.any():
                # DictionaryBlock carries nulls via its dictionary entries:
                # route NULL rows to an appended None entry
                ids[nulls] = len(entries)
                entries.append(None)
            blocks.append(DictionaryBlock(
                ids, VariableWidthBlock.from_strings(entries)))
            continue
        if isinstance(typ, (VarcharType, CharType)):
            raise NotImplementedError("varchar column without dictionary")
        if isinstance(typ, DecimalType) and not typ.is_short:
            # the device accumulates long decimals in int64; widen here
            ints = [None if (nulls is not None and nulls[i]) else int(v)
                    for i, v in enumerate(values)]
            blocks.append(Int128Block.from_ints(ints, nulls))
            continue
        if isinstance(typ, BooleanType):
            values = values.astype(np.int8)
        elif isinstance(typ, DoubleType):
            pass  # float bits pass through FixedWidthBlock
        elif values.dtype not in (np.int8, np.int16, np.int32, np.int64):
            values = values.astype(typ.np_dtype)
        if isinstance(typ, (IntegerType, DateType)):
            values = values.astype(np.int32)
        blocks.append(FixedWidthBlock(values, nulls))
    return Page(blocks, int(keep.numel()))
