"""Numpy reference executor: interprets the same plan IR on the host.

The port's own copy of presto_tpu/exec/reference.py (host numpy, no
torch): it shares the port's plan IR, catalog and data generators and
takes the port's `canonical_name` / `constant_device_value` and string
tables from exec/lowering.py.  One difference: a REAL output column
becomes a Python float (the reference's `_to_rows` turns it into an int).

The differential-testing oracle, playing the role H2 plays in the reference's
QueryAssertions (presto-tests/.../tests/QueryAssertions.java:52,
H2QueryRunner.java:105): every conformance test runs a query on the engine
and on this interpreter over identical generated data and diffs results.
Implementation is deliberately simple row/column numpy code sharing nothing
with the device engine (batch.py / operators.py / lowering.py) except the plan
IR and the data generator.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.types import (ArrayType, BooleanType, CharType, DateType,
                            DecimalType, DoubleType, RealType, Type,
                            VarcharType)
from ..connectors import catalog, tpch
from ..spi import plan as P
from ..spi.expr import (CallExpression, ConstantExpression, RowExpression,
                        SpecialFormExpression, VariableReferenceExpression)
from .lowering import canonical_name, constant_device_value

Col = Tuple[np.ndarray, Optional[np.ndarray]]  # (values, nulls|None)


class Table:
    """name -> (values, nulls). Strings are object arrays, decimals unscaled
    int64 (object for >int64), dates int days."""

    def __init__(self, cols: Dict[str, Col], n: int):
        self.cols = cols
        self.n = n

    def mask(self, keep: np.ndarray) -> "Table":
        return Table({k: (v[keep], None if m is None else m[keep])
                      for k, (v, m) in self.cols.items()}, int(keep.sum()))

    def take(self, idx: np.ndarray) -> "Table":
        return Table({k: (v[idx], None if m is None else m[idx])
                      for k, (v, m) in self.cols.items()}, len(idx))


# when set (execute_reference(stats=...)), _exec fills it with one
# entry per plan node id: {"rows", "wall_s", "batches", "operatorType"}
# — the oracle-side twin of the engine's OperatorStats spine, so
# differential tests can diff the stats SURFACE, not just result rows
_ACTIVE_STATS: Optional[Dict[str, dict]] = None


def execute_reference(node: P.PlanNode,
                      stats: Optional[Dict[str, dict]] = None) -> List[List]:
    """Run a plan, return rows of python values (Decimal for decimals).

    Pass a dict as `stats` to collect per-node operator stats: rows is
    the node's output cardinality, wall_s its INCLUSIVE interpretation
    wall (the interpreter recurses, so a node's wall covers its
    subtree), batches is always 1 (the oracle is single-batch)."""
    global _ACTIVE_STATS
    prev = _ACTIVE_STATS
    _ACTIVE_STATS = stats
    try:
        table = _exec(node)
    finally:
        _ACTIVE_STATS = prev
    names = [v.name for v in node.output_variables]
    types = [v.type for v in node.output_variables]
    return _to_rows(table, names, types)


def _to_rows(table: Table, names, types) -> List[List]:
    from decimal import Decimal
    out = []
    for i in range(table.n):
        row = []
        for name, typ in zip(names, types):
            v, m = table.cols[name]
            if m is not None and m[i]:
                row.append(None)
            elif isinstance(typ, ArrayType):
                row.append(None if v[i] is None
                           else [_py_element(typ.element, e) for e in v[i]])
            elif isinstance(typ, DecimalType):
                row.append(Decimal(int(v[i])) / (10 ** typ.scale))
            elif isinstance(typ, (DoubleType, RealType)):
                row.append(float(v[i]))
            elif isinstance(typ, BooleanType):
                row.append(bool(v[i]))
            elif isinstance(typ, (VarcharType, CharType)):
                row.append(str(v[i]))
            elif isinstance(typ, DateType):
                row.append(str(np.datetime64(int(v[i]), "D")))
            else:
                row.append(int(v[i]))
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# node execution
# ---------------------------------------------------------------------------

def _py_element(etyp: Type, e):
    """Array element -> plain python value (mirrors block_to_values)."""
    if e is None:
        return None
    if isinstance(etyp, (DoubleType, RealType)):
        return float(e)
    if isinstance(etyp, BooleanType):
        return bool(e)
    if isinstance(etyp, (VarcharType, CharType)):
        return str(e)
    if isinstance(etyp, DateType):
        return str(np.datetime64(int(e), "D"))
    from decimal import Decimal
    if isinstance(etyp, DecimalType):
        return Decimal(int(e)) / (10 ** etyp.scale)
    return int(e)


def _exec(node: P.PlanNode) -> Table:
    fn = globals().get("_exec_" + type(node).__name__)
    if fn is None:
        raise NotImplementedError(type(node).__name__)
    if _ACTIVE_STATS is None:
        return fn(node)
    import time
    t0 = time.perf_counter()  # lint: allow-wall-clock
    table = fn(node)
    wall = time.perf_counter() - t0  # lint: allow-wall-clock
    nid = getattr(node, "id", None)
    if nid is not None:
        _ACTIVE_STATS[str(nid)] = {
            "rows": int(table.n),
            "wall_s": wall,
            "batches": 1,
            "operatorType": type(node).__name__.replace("Node", ""),
        }
    return table


def _exec_TableScanNode(node: P.TableScanNode) -> Table:
    th = node.table
    sf = dict(th.extra).get("scaleFactor", 0.01)
    n = catalog.table_row_count(th.table_name, sf, th.connector_id)
    cols = {}
    for v in node.outputs:
        cname = node.assignments[v].name
        raw = catalog.generate_column(th.table_name, cname, sf, 0, n,
                                      th.connector_id)
        nulls = None
        if isinstance(raw, catalog.HostColumn):
            nulls = raw.nulls
            raw = raw.values
        if isinstance(raw, tuple):
            codes, values = raw
            arr = np.array(values, dtype=object)[codes]
        elif isinstance(raw, list):
            arr = np.array(raw, dtype=object)
        else:
            arr = raw
        if nulls is not None and arr.dtype == object:
            # null strings surface as None VALUES too: grouping compares
            # values, so a masked row must not alias its code-0 entry
            arr = arr.copy()
            arr[nulls] = None
        cols[v.name] = (arr, nulls)
    return Table(cols, n)


def _exec_ValuesNode(node: P.ValuesNode) -> Table:
    cols = {}
    for i, v in enumerate(node.outputs):
        vals, nulls = [], []
        for row in node.rows:
            c = row[i]
            val = constant_device_value(c.value, v.type)
            nulls.append(val is None)
            vals.append(0 if val is None else val)
        cols[v.name] = (np.array(vals, dtype=object),
                        np.array(nulls) if any(nulls) else None)
    return Table(cols, len(node.rows))


def _exec_FilterNode(node: P.FilterNode) -> Table:
    t = _exec(node.source)
    v, m = _eval(node.predicate, t)
    keep = v.astype(bool)
    if m is not None:
        keep = keep & ~m
    return t.mask(keep)


def _exec_ProjectNode(node: P.ProjectNode) -> Table:
    t = _exec(node.source)
    cols = {}
    for var, expr in node.assignments.items():
        cols[var.name] = _eval(expr, t)
    return Table(cols, t.n)


def _exec_OutputNode(node: P.OutputNode) -> Table:
    t = _exec(node.source)
    inner = [v.name for v in node.source.output_variables]
    cols = {o.name: t.cols[i] for i, o in zip(inner, node.outputs)}
    return Table(cols, t.n)


def _exec_LimitNode(node: P.LimitNode) -> Table:
    t = _exec(node.source)
    idx = np.arange(min(node.count, t.n))
    return t.take(idx)


def _exec_ExchangeNode(node: P.ExchangeNode) -> Table:
    parts = []
    for i, s in enumerate(node.exchange_sources):
        t = _exec(s)
        if node.inputs:
            mapping = {o.name: iv.name for o, iv in
                       zip(node.partitioning_scheme.output_layout,
                           node.inputs[i])}
            t = Table({o: t.cols[iv] for o, iv in mapping.items()}, t.n)
        parts.append(t)
    if len(parts) == 1:
        return parts[0]
    names = list(parts[0].cols)
    cols = {}
    for nm in names:
        vals = np.concatenate([p.cols[nm][0] for p in parts])
        if any(p.cols[nm][1] is not None for p in parts):
            nulls = np.concatenate([
                p.cols[nm][1] if p.cols[nm][1] is not None
                else np.zeros(p.n, bool) for p in parts])
        else:
            nulls = None
        cols[nm] = (vals, nulls)
    return Table(cols, sum(p.n for p in parts))


def _sort_key_arrays(t: Table, orderings) -> list:
    arrays = []
    for var, order in reversed(orderings):
        v, m = t.cols[var.name]
        desc = order.startswith("DESC")
        if v.dtype == object:
            # rank-encode object values; masked payloads may hold
            # type-mismatched fill (a grouping-set union's null branch
            # fills varchar keys with int zeros) — treat them as None
            items = v.tolist()
            if m is not None:
                items = [None if m[i] else x for i, x in enumerate(items)]
            uniq = sorted(set(items), key=lambda x: (x is None, x))
            rank = {u: i for i, u in enumerate(uniq)}
            v = np.array([rank[x] for x in items], dtype=np.int64)
        vv = v.astype(np.float64) if v.dtype != np.float64 else v.copy()
        vv = np.where(np.isnan(vv), np.inf, vv)
        key = -vv if desc else vv
        if m is not None:
            nulls_first = order.endswith("NULLS_FIRST")
            key = np.where(m, -np.inf if nulls_first else np.inf, key)
        arrays.append(key)
    return arrays


def _exec_SortNode(node: P.SortNode) -> Table:
    t = _exec(node.source)
    idx = np.lexsort(tuple(_sort_key_arrays(t, node.ordering_scheme.orderings)))
    return t.take(idx)


def _exec_TopNNode(node: P.TopNNode) -> Table:
    t = _exec(node.source)
    idx = np.lexsort(tuple(_sort_key_arrays(t, node.ordering_scheme.orderings)))
    return t.take(idx[:node.count])


def _exec_UnionNode(node: P.UnionNode) -> Table:
    tables = [_exec(s) for s in node.inputs]
    cols: Dict[str, Col] = {}
    for v in node.outputs:
        n = v.name
        vals = [t.cols[n][0] for t in tables]
        nulls = [t.cols[n][1] for t in tables]
        if any(x.dtype == object for x in vals):
            vv = np.concatenate([np.asarray(x, dtype=object) for x in vals])
        else:
            vv = np.concatenate(vals)
        if any(m is not None for m in nulls):
            mm = np.concatenate([np.zeros(len(x), dtype=bool)
                                 if m is None else m
                                 for x, m in zip(vals, nulls)])
        else:
            mm = None
        cols[n] = (vv, mm)
    return Table(cols, sum(t.n for t in tables))


def _exec_WindowNode(node: P.WindowNode) -> Table:
    """Per-partition python loop (independent of the device engine's
    segmented-scan formulation).  Supports ranking functions
    (row_number/rank/dense_rank/ntile/percent_rank/cume_dist), value
    functions (lag/lead/first_value/last_value/nth_value) and frame
    aggregates with ROWS offset frames and RANGE
    unbounded/current-row frames (reference WindowOperator.java:69 +
    operator/window/)."""
    t = _exec(node.source)
    n = t.n
    part_vars = node.partition_by
    orderings = list(node.ordering_scheme.orderings) \
        if node.ordering_scheme else []
    sort_specs = [(v, "ASC_NULLS_FIRST") for v in part_vars] + orderings
    if sort_specs and n:
        t = t.take(np.lexsort(tuple(_sort_key_arrays(t, sort_specs))))

    def change_flags(names) -> np.ndarray:
        d = np.zeros(n, dtype=bool)
        if n:
            d[0] = True
        for name in names:
            v, m = t.cols[name]
            a, b = v[1:], v[:-1]
            if v.dtype == np.float64:
                eq = (a == b) | (np.isnan(a) & np.isnan(b))
            else:
                eq = np.asarray(a == b, dtype=bool)
            if m is not None:
                eq = np.where(m[1:] | m[:-1], m[1:] & m[:-1], eq)
            d[1:] |= ~np.asarray(eq, dtype=bool)
        return d

    part_start = change_flags([v.name for v in part_vars])
    peer_start = part_start | change_flags([v.name for v, _ in orderings])
    bounds = np.append(np.flatnonzero(part_start), n)

    def peer_range(s, e, i):
        """[gs, ge) peer group of row i within partition [s, e)."""
        gs = i
        while gs > s and not peer_start[gs]:
            gs -= 1
        ge = i + 1
        while ge < e and not peer_start[ge]:
            ge += 1
        return gs, ge

    def frame_rows(frame, s, e, i):
        """Row index list of the frame of row i in partition [s, e)."""
        if frame is None:
            _gs, ge = peer_range(s, e, i)
            return range(s, ge)
        ftype = frame["type"]
        sk, so = frame["startKind"], frame["startOffset"]
        ek, eo = frame["endKind"], frame["endOffset"]
        if ftype == "RANGE":
            gs, ge = peer_range(s, e, i)
            lo = s if sk == "UNBOUNDED_PRECEDING" else gs
            hi = ge if ek == "CURRENT" else e
            return range(lo, hi)
        lo = {"UNBOUNDED_PRECEDING": s, "CURRENT": i,
              "PRECEDING": i - (so or 0), "FOLLOWING": i + (so or 0),
              "UNBOUNDED_FOLLOWING": e}[sk]
        hi = {"UNBOUNDED_FOLLOWING": e - 1, "CURRENT": i,
              "PRECEDING": i - (eo or 0), "FOLLOWING": i + (eo or 0),
              "UNBOUNDED_PRECEDING": s - 1}[ek]
        return range(max(lo, s), min(hi, e - 1) + 1)

    new_cols = dict(t.cols)
    for var, wf in node.window_functions.items():
        fname = canonical_name(wf.call.display_name)
        args = wf.call.arguments
        frame = wf.frame

        if fname in ("row_number", "rank", "dense_rank", "ntile",
                     "percent_rank", "cume_dist"):
            is_f = fname in ("percent_rank", "cume_dist")
            out = np.zeros(n, dtype=np.float64 if is_f else np.int64)
            for s, e in zip(bounds[:-1], bounds[1:]):
                size = e - s
                if fname == "ntile":
                    nt = int(args[0].value)
                    q, r = divmod(size, nt)
                    for i in range(s, e):
                        rn = i - s
                        big = r * (q + 1)
                        out[i] = (rn // (q + 1) if rn < big
                                  else r + (rn - big) // max(q, 1)) + 1
                    continue
                rk = dr = 0
                for i in range(s, e):
                    if peer_start[i] or i == s:
                        rk = i - s + 1
                        dr += 1
                    if fname == "row_number":
                        out[i] = i - s + 1
                    elif fname == "rank":
                        out[i] = rk
                    elif fname == "dense_rank":
                        out[i] = dr
                    elif fname == "percent_rank":
                        out[i] = 0.0 if size <= 1 else (rk - 1) / (size - 1)
                    else:   # cume_dist
                        _gs, ge = peer_range(s, e, i)
                        out[i] = (ge - s) / size
            new_cols[var.name] = (out, None)
            continue

        if fname in ("lag", "lead", "first_value", "last_value",
                     "nth_value"):
            vals, nulls = t.cols[args[0].name]
            from .lowering import constant_device_value
            outv = (np.zeros(n, dtype=vals.dtype) if vals.dtype != object
                    else np.empty(n, dtype=object))
            outn = np.zeros(n, dtype=bool)
            for s, e in zip(bounds[:-1], bounds[1:]):
                for i in range(s, e):
                    if fname in ("lag", "lead"):
                        off = int(args[1].value) if len(args) > 1 else 1
                        src_i = i - off if fname == "lag" else i + off
                        if s <= src_i < e:
                            outv[i] = vals[src_i]
                            outn[i] = bool(nulls[src_i]) if nulls is not None \
                                else False
                        elif len(args) > 2:
                            dv = constant_device_value(args[2].value,
                                                       args[2].type)
                            if dv is None:
                                outn[i] = True
                            else:
                                outv[i] = dv
                        else:
                            outn[i] = True
                        continue
                    rows = list(frame_rows(frame, s, e, i))
                    if fname == "first_value":
                        src_i = rows[0] if rows else None
                    elif fname == "last_value":
                        src_i = rows[-1] if rows else None
                    else:
                        k = int(args[1].value) if len(args) > 1 else 1
                        src_i = rows[k - 1] if len(rows) >= k else None
                    if src_i is None:
                        outn[i] = True
                    else:
                        outv[i] = vals[src_i]
                        outn[i] = bool(nulls[src_i]) if nulls is not None \
                            else False
            new_cols[var.name] = (outv, outn if outn.any() else None)
            continue

        star = fname == "count" and not args
        if star:
            vals, nulls = np.ones(n, dtype=np.int64), None
        else:
            vals, nulls = t.cols[args[0].name]
        notnull = np.ones(n, dtype=bool) if nulls is None else ~nulls
        out_is_float = isinstance(wf.call.type, (DoubleType, RealType))
        if fname == "count":
            outv = np.zeros(n, dtype=np.int64)
        elif fname in ("min", "max") or not out_is_float:
            outv = np.zeros(n, dtype=vals.dtype)
        else:
            outv = np.zeros(n, dtype=np.float64)
        outn = np.zeros(n, dtype=bool)
        for s, e in zip(bounds[:-1], bounds[1:]):
            for i in range(s, e):
                rows = [j for j in frame_rows(frame, s, e, i)
                        if star or notnull[j]]
                cnt = len(rows)
                if fname == "count":
                    outv[i] = cnt
                    continue
                if cnt == 0:
                    outn[i] = True      # aggregate of no rows is NULL
                    continue
                xs = [vals[j] for j in rows]
                if fname == "sum":
                    outv[i] = sum(xs)
                elif fname == "avg":
                    sm = sum(xs)
                    if out_is_float:
                        outv[i] = sm / cnt
                    else:
                        si = int(sm)    # decimal: round-half-up
                        sign = -1 if si < 0 else 1
                        outv[i] = sign * ((abs(si) + cnt // 2) // cnt)
                elif fname == "min":
                    outv[i] = min(xs)
                elif fname == "max":
                    outv[i] = max(xs)
                else:
                    raise NotImplementedError(fname)
        new_cols[var.name] = (outv, outn if outn.any() else None)
    return Table(new_cols, n)


def _exec_AggregationNode(node: P.AggregationNode) -> Table:
    t = _exec(node.source)
    key_names = [v.name for v in node.grouping_keys]
    if key_names:
        key_cols = [t.cols[k] for k in key_names]
        combo = np.empty(t.n, dtype=object)
        for i in range(t.n):
            # group identity is null-aware and sortable: a NULL key
            # (None value or set mask bit) is one group, distinct from
            # every real value — (is_null, value) keeps np.unique's sort
            # total even when a column mixes None with strings
            combo[i] = tuple(
                (True, "") if (a[i] is None
                               or (m is not None and bool(m[i])))
                else (False, a[i])
                for a, m in key_cols)
        uniq, inverse = np.unique(combo, return_inverse=True)
        n_groups = len(uniq)
    else:
        inverse = np.zeros(t.n, dtype=np.int64)
        n_groups = 1
    cols: Dict[str, Col] = {}
    for k in key_names:
        src, m = t.cols[k]
        first = np.zeros(n_groups, dtype=src.dtype) if src.dtype != object \
            else np.empty(n_groups, dtype=object)
        firstm = np.zeros(n_groups, dtype=bool)
        for i in range(t.n - 1, -1, -1):
            first[inverse[i]] = src[i]
            if m is not None:
                firstm[inverse[i]] = m[i]
        cols[k] = (first, firstm if m is not None and firstm.any() else None)

    # group slices once: rows sorted by group id, reduceat over boundaries
    order = np.argsort(inverse, kind="stable")
    sorted_inv = inverse[order]
    # boundary start index of each present group; absent groups impossible
    # (inverse comes from np.unique)
    starts = np.zeros(n_groups, dtype=np.int64)
    if t.n:
        boundaries = np.flatnonzero(np.diff(sorted_inv)) + 1
        starts[sorted_inv[0]] = 0
        starts = np.concatenate([[0], boundaries]) if n_groups > 1 else starts[:1]

    for var, agg in node.aggregations.items():
        fname = canonical_name(agg.call.display_name)
        if agg.call.arguments:
            av, am = _eval(agg.call.arguments[0], t)
        else:
            av, am = np.ones(t.n, dtype=np.int64), None
        valid = np.ones(t.n, dtype=bool) if am is None else ~am
        sv = av[order]
        svalid = valid[order]
        counts = np.add.reduceat(svalid.astype(np.int64), starts) \
            if t.n else np.zeros(n_groups, dtype=np.int64)
        outm = counts == 0
        if fname == "count":
            cols[var.name] = (counts.astype(object), None)
            continue
        # exact integer sums via object dtype; floats stay float64
        if sv.dtype != object and not np.issubdtype(sv.dtype, np.floating):
            sv = sv.astype(object)
        if fname in ("sum", "avg"):
            zero = 0.0 if np.issubdtype(np.asarray(sv[:1]).dtype, np.floating) \
                and sv.dtype != object else 0
            masked = np.where(svalid, sv, zero)
            sums = np.add.reduceat(masked, starts) if t.n else \
                np.zeros(n_groups, dtype=object)
            if fname == "sum":
                cols[var.name] = (np.asarray(sums, dtype=object),
                                  outm if outm.any() else None)
            else:
                safe = np.where(outm, 1, counts)
                if isinstance(var.type, DoubleType):
                    out = np.array([float(s) / int(c)
                                    for s, c in zip(sums, safe)])
                else:
                    out = np.empty(n_groups, dtype=object)
                    for g in range(n_groups):
                        s, c = int(sums[g]), int(safe[g])
                        q = (abs(s) + c // 2) // c
                        out[g] = q if s >= 0 else -q
                cols[var.name] = (out, outm if outm.any() else None)
        elif fname in ("min", "max"):
            big = float("inf") if fname == "min" else float("-inf")
            masked = np.where(svalid, sv, big)
            red = np.minimum.reduceat if fname == "min" else np.maximum.reduceat
            vals = red(masked, starts) if t.n else np.full(n_groups, big)
            cols[var.name] = (np.asarray(vals, dtype=object),
                              outm if outm.any() else None)
        elif fname in ("stddev", "stddev_pop", "stddev_samp", "variance",
                       "var_pop", "var_samp"):
            pop = fname in ("stddev_pop", "var_pop")
            sqrt = fname.startswith("stddev")
            out = np.zeros(n_groups, dtype=np.float64)
            outm = np.zeros(n_groups, dtype=bool)
            ends = np.append(starts[1:], t.n)
            for g in range(n_groups):
                xs = [float(sv[i]) for i in range(starts[g], ends[g])
                      if svalid[i]] if t.n else []
                k = len(xs)
                if k < (1 if pop else 2):
                    outm[g] = True
                    continue
                m = sum(xs) / k
                m2 = sum((x - m) ** 2 for x in xs)
                v = m2 / (k if pop else k - 1)
                out[g] = v ** 0.5 if sqrt else v
            cols[var.name] = (out, outm if outm.any() else None)
        elif fname in ("corr", "covar_pop", "covar_samp"):
            bv, bm = _eval(agg.call.arguments[1], t)
            bvalid = np.ones(t.n, dtype=bool) if bm is None else ~bm
            sb = bv[order]
            sbvalid = (svalid & bvalid[order])
            out = np.zeros(n_groups, dtype=np.float64)
            outm = np.zeros(n_groups, dtype=bool)
            ends = np.append(starts[1:], t.n)
            for g in range(n_groups):
                pairs = [(float(sv[i]), float(sb[i]))
                         for i in range(starts[g], ends[g])
                         if sbvalid[i]] if t.n else []
                k = len(pairs)
                if fname == "corr":
                    if k < 1:
                        outm[g] = True
                        continue
                    sx = sum(x for x, _ in pairs)
                    sy = sum(y for _, y in pairs)
                    sxy = sum(x * y for x, y in pairs)
                    sx2 = sum(x * x for x, _ in pairs)
                    sy2 = sum(y * y for _, y in pairs)
                    den = ((k * sx2 - sx * sx) * (k * sy2 - sy * sy)) ** 0.5
                    if den == 0:
                        outm[g] = True
                        continue
                    out[g] = (k * sxy - sx * sy) / den
                    continue
                need = 1 if fname == "covar_pop" else 2
                if k < need:
                    outm[g] = True
                    continue
                mx = sum(x for x, _ in pairs) / k
                my = sum(y for _, y in pairs) / k
                c = sum((x - mx) * (y - my) for x, y in pairs)
                out[g] = c / (k if fname == "covar_pop" else k - 1)
            cols[var.name] = (out, outm if outm.any() else None)
        elif fname == "approx_distinct":
            # oracle returns the EXACT distinct count; tests comparing the
            # engine's HLL estimate must tolerate the documented standard
            # error (1.04/sqrt(buckets)) rather than assert equality
            out = np.zeros(n_groups, dtype=np.int64)
            ends = np.append(starts[1:], t.n)
            for g in range(n_groups):
                out[g] = len({sv[i] for i in range(starts[g], ends[g])
                              if svalid[i]}) if t.n else 0
            cols[var.name] = (out, None)
        elif fname == "approx_percentile":
            p = float(agg.call.arguments[1].value) \
                if len(agg.call.arguments) > 1 else 0.5
            outv = np.empty(n_groups, dtype=object)
            outm = np.zeros(n_groups, dtype=bool)
            ends = np.append(starts[1:], t.n)
            for g in range(n_groups):
                xs = sorted(sv[i] for i in range(starts[g], ends[g])
                            if svalid[i]) if t.n else []
                if not xs:
                    outm[g] = True
                    outv[g] = 0
                    continue
                # nearest rank, matching ops.sort_group_aggregate:
                # round-half-up of p * (n-1)
                import math
                outv[g] = xs[int(math.floor(p * (len(xs) - 1) + 0.5))]
            cols[var.name] = (outv, outm if outm.any() else None)
        else:
            raise NotImplementedError(fname)
    return Table(cols, n_groups)


def _exec_JoinNode(node: P.JoinNode) -> Table:
    left = _exec(node.left)
    right = _exec(node.right)
    lkeys = [l.name for l, r in node.criteria]
    rkeys = [r.name for l, r in node.criteria]
    index: Dict[tuple, list] = {}
    for i in range(right.n):
        key = tuple(right.cols[k][0][i] for k in rkeys)
        if any(right.cols[k][1] is not None and right.cols[k][1][i]
               for k in rkeys):
            continue
        index.setdefault(key, []).append(i)
    # 1. matched pairs (INNER expansion)
    li, ri = [], []
    for i in range(left.n):
        key = tuple(left.cols[k][0][i] for k in lkeys)
        matches = index.get(key, [])
        if any(left.cols[k][1] is not None and left.cols[k][1][i]
               for k in lkeys):
            matches = []
        for j in matches:
            li.append(i)
            ri.append(j)
    li = np.array(li, dtype=np.int64)
    ri = np.array(ri, dtype=np.int64)
    cols = {}
    for name, (v, m) in left.cols.items():
        cols[name] = (v[li], None if m is None else m[li])
    for name, (v, m) in right.cols.items():
        cols[name] = (v[ri], None if m is None else m[ri])
    out_names = [v.name for v in node.outputs]
    # the ON filter may read columns pruned from the output list: evaluate
    # over the full pair table, project to out_names after
    keep_names = list(out_names)
    if node.filter is not None:
        from ..spi.expr import free_variables
        for fv in free_variables(node.filter):
            if fv.name in cols and fv.name not in keep_names:
                keep_names.append(fv.name)
    pairs = Table({n: cols[n] for n in keep_names}, len(li))

    # 2. ON filter applies to pairs BEFORE null-extension (SQL semantics)
    keep = np.ones(pairs.n, dtype=bool)
    if node.filter is not None and pairs.n:
        v, m = _eval(node.filter, pairs)
        keep = v.astype(bool)
        if m is not None:
            keep &= ~m
    pairs = pairs.mask(keep)
    pairs = Table({n: pairs.cols[n] for n in out_names}, pairs.n)

    if node.join_type not in (P.LEFT, P.FULL):
        return pairs

    # 3. LEFT/FULL: null-extend rows of the preserved side(s) with no
    # surviving match
    def extend(side: Table, other: Table, kept_idx: np.ndarray) -> Table:
        surviving = set(kept_idx.tolist())
        miss = np.array([i for i in range(side.n) if i not in surviving],
                        dtype=np.int64)
        cols = {}
        for n in out_names:
            if n in side.cols:
                v, m = side.cols[n]
                cols[n] = (v[miss], None if m is None else m[miss])
            else:
                v, _ = other.cols[n]
                ev = np.zeros(len(miss), dtype=v.dtype) \
                    if v.dtype != object \
                    else np.empty(len(miss), dtype=object)
                cols[n] = (ev, np.ones(len(miss), dtype=bool))
        return Table(cols, len(miss))

    parts = [pairs, extend(left, right, li[keep])]
    if node.join_type == P.FULL:
        parts.append(extend(right, left, ri[keep]))
    cols = {}
    for n in out_names:
        vals = np.concatenate([p.cols[n][0] for p in parts])
        if any(p.cols[n][1] is not None for p in parts):
            nm = np.concatenate([p.cols[n][1] if p.cols[n][1] is not None
                                 else np.zeros(p.n, dtype=bool)
                                 for p in parts])
        else:
            nm = None
        cols[n] = (vals, nm)
    return Table(cols, sum(p.n for p in parts))


def _exec_DistinctLimitNode(node: P.DistinctLimitNode) -> Table:
    """First `count` distinct rows in scan order (DistinctLimitOperator)."""
    src = _exec(node.source)
    names = [v.name for v in node.distinct_variables]
    seen = set()
    take: List[int] = []
    for i in range(src.n):
        key = tuple(
            None if (src.cols[n][1] is not None and src.cols[n][1][i])
            else src.cols[n][0][i]
            for n in names)
        if key not in seen:
            seen.add(key)
            take.append(i)
            if len(take) >= node.count:
                break
    return src.take(np.array(take, dtype=np.int64))


def _exec_AssignUniqueIdNode(node: P.AssignUniqueIdNode) -> Table:
    t = _exec(node.source)
    cols = dict(t.cols)
    cols[node.id_variable.name] = (np.arange(t.n, dtype=np.int64), None)
    return Table(cols, t.n)


def _exec_EnforceSingleRowNode(node: P.EnforceSingleRowNode) -> Table:
    t = _exec(node.source)
    if t.n > 1:
        raise RuntimeError("scalar subquery produced more than one row")
    return t


def _exec_SemiJoinNode(node: P.SemiJoinNode) -> Table:
    """Three-valued marker (reference HashSemiJoinOperator): TRUE on match,
    NULL when the probe key is NULL or the build side contains NULL and
    there is no match, FALSE only on a definite miss."""
    src = _exec(node.source)
    filt = _exec(node.filtering_source)
    fv, fm = filt.cols[node.filtering_source_join_variable.name]
    fvals = {x for i, x in enumerate(fv.tolist())
             if fm is None or not fm[i]}     # NULL keys never match
    build_has_null = fm is not None and bool(np.any(fm))
    sv, sm = src.cols[node.source_join_variable.name]
    marker = np.zeros(src.n, dtype=bool)
    nulls = np.zeros(src.n, dtype=bool)
    for i, x in enumerate(sv.tolist()):
        if sm is not None and sm[i]:
            nulls[i] = True
        elif x in fvals:
            marker[i] = True
        elif build_has_null:
            nulls[i] = True
    cols = dict(src.cols)
    cols[node.semi_join_output.name] = (marker, nulls if nulls.any() else None)
    return Table(cols, src.n)


# ---------------------------------------------------------------------------
# expression interpreter
# ---------------------------------------------------------------------------

def _eval(expr: RowExpression, t: Table) -> Col:
    if isinstance(expr, VariableReferenceExpression):
        return t.cols[expr.name]
    if isinstance(expr, ConstantExpression):
        val = constant_device_value(expr.value, expr.type)
        if val is None:
            return (np.zeros(t.n, dtype=object), np.ones(t.n, dtype=bool))
        if isinstance(expr.type, (VarcharType, CharType)):
            return (np.array([str(val)] * t.n, dtype=object), None)
        return (np.full(t.n, val, dtype=object
                        if isinstance(val, int) and abs(val) > 2**62
                        else np.int64
                        if isinstance(val, (int, np.integer)) else np.float64),
                None)
    if isinstance(expr, CallExpression):
        return _eval_call(expr, t)
    if isinstance(expr, SpecialFormExpression):
        return _eval_special(expr, t)
    raise NotImplementedError(type(expr).__name__)


def _both(a: Col, b: Col):
    m = None
    if a[1] is not None or b[1] is not None:
        m = (a[1] if a[1] is not None else np.zeros(len(a[0]), bool)) | \
            (b[1] if b[1] is not None else np.zeros(len(b[0]), bool))
    return a[0], b[0], m


def _scale_factor(expr: RowExpression) -> int:
    return expr.type.scale if isinstance(expr.type, DecimalType) else 0


def _to_scale(values: np.ndarray, frm: int, to: int):
    if to == frm:
        return values
    if to > frm:
        return values * (10 ** (to - frm))
    den = 10 ** (frm - to)
    out = np.empty(len(values), dtype=object)
    for i, x in enumerate(values.tolist()):
        q = (abs(int(x)) + den // 2) // den
        out[i] = q if x >= 0 else -q
    return out


def _numeric_domain(expr: RowExpression, col: Col, target_float: bool,
                    target_scale: int) -> np.ndarray:
    v = col[0]
    if target_float:
        s = _scale_factor(expr)
        return np.array([float(x) / 10**s for x in v.tolist()], dtype=np.float64) \
            if s else v.astype(np.float64)
    return _to_scale(v, _scale_factor(expr), target_scale)


def _eval_call(expr: CallExpression, t: Table) -> Col:
    name = canonical_name(expr.display_name)
    args = expr.arguments
    if name in ("array_constructor", "subscript", "element_at",
                "cardinality", "contains", "array_max", "array_min",
                "array_position", "repeat", "sequence"):
        return _eval_array_fn(name, expr, t)
    if name in ("add", "subtract", "multiply", "divide", "modulus"):
        a = _eval(args[0], t)
        b = _eval(args[1], t)
        av, bv, m = _both(a, b)
        is_float = isinstance(expr.type, (DoubleType, RealType))
        if is_float:
            af = _numeric_domain(args[0], a, True, 0)
            bf = _numeric_domain(args[1], b, True, 0)
            op = {"add": np.add, "subtract": np.subtract,
                  "multiply": np.multiply, "divide": np.divide,
                  "modulus": np.mod}[name]
            return (op(af, bf), m)
        rs = _scale_factor(expr)
        sa, sb = _scale_factor(args[0]), _scale_factor(args[1])
        ai = [int(x) for x in av.tolist()]
        bi = [int(x) for x in bv.tolist()]
        out = np.empty(len(ai), dtype=object)
        div0 = None
        for i in range(len(ai)):
            x, y = ai[i], bi[i]
            if name == "add":
                out[i] = x * 10**(rs - sa) + y * 10**(rs - sb)
            elif name == "subtract":
                out[i] = x * 10**(rs - sa) - y * 10**(rs - sb)
            elif name == "multiply":
                p = x * y  # scale sa+sb
                out[i] = _round_to(p, sa + sb, rs)
            elif name == "divide":
                if y == 0:
                    # engine semantics: integer/decimal division by zero
                    # yields NULL (a data-dependent raise cannot live
                    # inside jit; the engine documents NULL instead)
                    out[i] = 0
                    div0 = np.zeros(len(ai), bool) if div0 is None else div0
                    div0[i] = True
                    continue
                num = x * 10**(rs + sb - sa)
                if isinstance(expr.type, DecimalType):
                    # decimal divide rounds half-up at the result scale
                    q = (abs(num) + abs(y) // 2) // abs(y)
                else:
                    # SQL integer division truncates toward zero
                    q = abs(num) // abs(y)
                out[i] = q * (1 if (num >= 0) == (y >= 0) else -1)
            elif name == "modulus":
                if y == 0:
                    out[i] = 0
                    div0 = np.zeros(len(ai), bool) if div0 is None else div0
                    div0[i] = True
                    continue
                xs, ys = x * 10**(rs - sa), y * 10**(rs - sb)
                out[i] = int(np.sign(xs)) * (abs(xs) % abs(ys))
        if div0 is not None:
            m = div0 if m is None else (m | div0)
        return (out, m)
    if name in ("eq", "neq", "lt", "lte", "gt", "gte"):
        a, b = _eval(args[0], t), _eval(args[1], t)
        av, bv, m = _both(a, b)
        if av.dtype == object and isinstance(av[0] if len(av) else "", str):
            import operator as op_
            ops = {"eq": op_.eq, "neq": op_.ne, "lt": op_.lt,
                   "lte": op_.le, "gt": op_.gt, "gte": op_.ge}
            return (np.array([ops[name](str(x), str(y))
                              for x, y in zip(av, bv)]), m)
        sa, sb = _scale_factor(args[0]), _scale_factor(args[1])
        s = max(sa, sb)
        fa = isinstance(args[0].type, (DoubleType, RealType))
        fb = isinstance(args[1].type, (DoubleType, RealType))
        if fa or fb:
            an = _numeric_domain(args[0], a, True, 0)
            bn = _numeric_domain(args[1], b, True, 0)
        else:
            an = _to_scale(av, sa, s)
            bn = _to_scale(bv, sb, s)
        ops = {"eq": np.equal, "neq": np.not_equal, "lt": np.less,
               "lte": np.less_equal, "gt": np.greater,
               "gte": np.greater_equal}
        an = np.array([int(x) for x in an.tolist()], dtype=object) \
            if an.dtype == object else an
        return (ops[name](an, bn), m)
    if name == "between":
        # Kleene: x BETWEEN lo AND hi == (x >= lo) AND (x <= hi); a NULL
        # bound still yields FALSE when the other comparison is FALSE
        # (fuzzer-found: the old null-if-any-null shortcut was wrong)
        return _eval_special(SpecialFormExpression(
            "AND", expr.type,
            [CallExpression("gte", expr.type, [args[0], args[1]]),
             CallExpression("lte", expr.type, [args[0], args[2]])]), t)
    if name == "not":
        v, m = _eval(args[0], t)
        return (~v.astype(bool), m)
    if name == "negate":
        v, m = _eval(args[0], t)
        return (np.array([-x for x in v.tolist()], dtype=v.dtype), m)
    if name == "abs":
        v, m = _eval(args[0], t)
        return (np.array([abs(x) for x in v.tolist()], dtype=v.dtype), m)
    if name in ("year", "month", "day", "quarter"):
        v, m = _eval(args[0], t)
        dates = v.astype("datetime64[D]")
        y = dates.astype("datetime64[Y]").astype(np.int64) + 1970
        mo = dates.astype("datetime64[M]").astype(np.int64) % 12 + 1
        d = (dates - dates.astype("datetime64[M]").astype("datetime64[D]")
             ).astype(np.int64) + 1
        part = {"year": y, "month": mo, "day": d, "quarter": (mo + 2) // 3}[name]
        return (part, m)
    if name == "cast":
        return _eval_cast(args[0], expr.type, t)
    if name == "like":
        from .lowering import like_matcher
        v, m = _eval(args[0], t)
        match = like_matcher(str(args[1].value))
        return (np.array([match(str(x)) for x in v]), m)
    if name == "substr":
        v, m = _eval(args[0], t)
        start = int(args[1].value)
        length = int(args[2].value) if len(args) > 2 else None

        def sub(s):
            i = start - 1 if start > 0 else len(s) + start
            return s[i:i + length] if length is not None else s[i:]
        return (np.array([sub(str(x)) for x in v], dtype=object), m)
    if name == "length":
        v, m = _eval(args[0], t)
        return (np.array([len(str(x)) for x in v], dtype=np.int64), m)
    if name in _REF_DOUBLE_FNS:
        fn = _REF_DOUBLE_FNS[name]
        acol = _eval(args[0], t)
        a = _numeric_domain(args[0], acol, True, 0)
        if name == "power":
            bcol = _eval(args[1], t)
            b = _numeric_domain(args[1], bcol, True, 0)
            m = acol[1]
            if bcol[1] is not None:
                m = bcol[1] if m is None else (m | bcol[1])
            return (np.array([fn(x, y) for x, y in zip(a, b)],
                             dtype=np.float64), m)
        return (np.array([fn(x) for x in a], dtype=np.float64), acol[1])
    if name in ("ceiling", "floor", "sign", "truncate"):
        import math as _math
        col = _eval(args[0], t)
        a = _numeric_domain(args[0], col, True, 0)
        fn = {"ceiling": _math.ceil, "floor": _math.floor,
              "truncate": _math.trunc,
              "sign": lambda x: (x > 0) - (x < 0)}[name]
        out = [fn(x) for x in a]
        if isinstance(expr.type, (DoubleType, RealType)):
            return (np.array(out, dtype=np.float64), col[1])
        return (np.array(out, dtype=np.int64), col[1])
    if name == "round":
        col = _eval(args[0], t)
        digits = int(args[1].value) if len(args) > 1 else 0
        if isinstance(expr.type, DecimalType):
            s = _scale_factor(args[0])
            rs = expr.type.scale
            out = np.empty(t.n, dtype=object)
            for i, x in enumerate(col[0].tolist()):
                x = int(x)
                if digits < s:
                    den = 10 ** (s - digits)
                    q = (abs(x) + den // 2) // den * den
                    x = q if x >= 0 else -q
                out[i] = _round_to(x, s, rs)
            return (out, col[1])
        a = _numeric_domain(args[0], col, True, 0)
        scale = 10.0 ** digits

        def r(x):
            import math as _math
            return _math.copysign(_math.floor(abs(x) * scale + 0.5),
                                  x) / scale
        out = np.array([r(x) for x in a], dtype=np.float64)
        if isinstance(expr.type, (DoubleType, RealType)):
            return (out, col[1])
        return (out.astype(np.int64), col[1])
    if name in ("greatest", "least"):
        cols = [_eval(a, t) for a in args]
        vals = [_numeric_domain(a, c, True, 0)
                for a, c in zip(args, cols)]
        out = vals[0]
        for v in vals[1:]:
            out = np.maximum(out, v) if name == "greatest" \
                else np.minimum(out, v)
        m = None
        for c in cols:
            if c[1] is not None:
                m = c[1] if m is None else (m | c[1])
        if isinstance(expr.type, (DoubleType, RealType)):
            return (out, m)
        sc = _scale_factor(expr)
        return (np.array([int(round(x * 10**sc)) for x in out],
                         dtype=object), m)
    if name in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                "replace", "lpad", "rpad"):
        v, m = _eval(args[0], t)
        extra = [a.value for a in args[1:]]
        fn = {
            "upper": lambda s: s.upper(),
            "lower": lambda s: s.lower(),
            "trim": lambda s: s.strip(),
            "ltrim": lambda s: s.lstrip(),
            "rtrim": lambda s: s.rstrip(),
            "reverse": lambda s: s[::-1],
            "replace": lambda s: s.replace(
                str(extra[0]), str(extra[1]) if len(extra) > 1 else ""),
            "lpad": lambda s: _ref_pad(s, extra, left=True),
            "rpad": lambda s: _ref_pad(s, extra, left=False),
        }[name]
        return (np.array([fn(str(x)) for x in v], dtype=object), m)
    if name == "concat":
        cols = [_eval(a, t) for a in args]
        m = None
        for c in cols:
            if c[1] is not None:
                m = c[1] if m is None else (m | c[1])
        out = np.array(["".join(str(c[0][i]) for c in cols)
                        for i in range(t.n)], dtype=object)
        return (out, m)
    if name == "strpos":
        v, m = _eval(args[0], t)
        sub = str(args[1].value)
        return (np.array([str(x).find(sub) + 1 for x in v],
                         dtype=np.int64), m)
    if name == "starts_with":
        v, m = _eval(args[0], t)
        p = str(args[1].value)
        return (np.array([str(x).startswith(p) for x in v]), m)
    if name in ("day_of_week", "day_of_year", "week", "date_trunc",
                "date_add", "date_diff"):
        return _eval_date_fn(name, expr, t)
    if name in ("regexp_like", "regexp_extract", "regexp_replace",
                "split_part", "ends_with", "codepoint",
                "url_extract_protocol", "url_extract_host",
                "url_extract_path", "url_extract_query",
                "url_extract_fragment", "url_extract_port",
                "json_extract_scalar"):
        return _eval_string_breadth(name, expr, t)
    if name in ("log", "atan2"):
        acol = _eval(args[0], t)
        a = _numeric_domain(args[0], acol, True, 0)
        bcol = _eval(args[1], t)
        b = _numeric_domain(args[1], bcol, True, 0)
        m = acol[1]
        if bcol[1] is not None:
            m = bcol[1] if m is None else (m | bcol[1])
        if name == "log":
            out = [_m.log(y) / _m.log(x) for x, y in zip(a, b)]
        else:
            out = [_m.atan2(x, y) for x, y in zip(a, b)]
        return (np.array(out, dtype=np.float64), m)
    if name in ("sinh", "cosh", "tanh"):
        col = _eval(args[0], t)
        a = _numeric_domain(args[0], col, True, 0)
        fn = {"sinh": _m.sinh, "cosh": _m.cosh, "tanh": _m.tanh}[name]
        return (np.array([fn(x) for x in a], dtype=np.float64), col[1])
    if name in ("is_nan", "is_finite", "is_infinite"):
        col = _eval(args[0], t)
        a = _numeric_domain(args[0], col, True, 0)
        fn = {"is_nan": _m.isnan, "is_finite": _m.isfinite,
              "is_infinite": _m.isinf}[name]
        return (np.array([fn(x) for x in a]), col[1])
    if name.startswith("bitwise_") or name == "width_bucket":
        cols = [_eval(a, t) for a in args]
        m = None
        for c in cols:
            if c[1] is not None:
                m = c[1] if m is None else (m | c[1])
        av = [int(x) for x in cols[0][0]]
        if name == "bitwise_not":
            return (np.array([~x for x in av], dtype=np.int64), m)
        if name == "width_bucket":
            xs = _numeric_domain(args[0], cols[0], True, 0)
            los = _numeric_domain(args[1], cols[1], True, 0)
            his = _numeric_domain(args[2], cols[2], True, 0)
            ns = [int(x) for x in cols[3][0]]
            out = []
            bad = np.zeros(t.n, dtype=bool)
            for i, (x, lo, hi, n) in enumerate(zip(xs, los, his, ns)):
                if n <= 0:         # error->NULL relaxation (engine mirror)
                    bad[i] = True
                    out.append(0)
                    continue
                span = (hi - lo) or 1.0
                # 1-ulp edge tolerance shared with the engine (see
                # lowering.py width_bucket)
                v = (x - lo) * n / span
                b = int(_m.floor(v * (1 + 2.0 ** -40))) + 1
                out.append(max(0, min(b, n + 1)))
            if bad.any():
                m = bad if m is None else (m | bad)
            return (np.array(out, dtype=np.int64), m)
        bv = [int(x) for x in cols[1][0]]
        if name in ("bitwise_left_shift", "bitwise_right_shift",
                    "bitwise_arithmetic_shift_right"):
            # int64 shift semantics shared with the engine (lowering.py):
            # counts >= 64 shift everything out (arithmetic-right
            # saturates to the sign fill); negative counts -> NULL
            out = []
            bad = np.zeros(t.n, dtype=bool)
            for i, (x, y) in enumerate(zip(av, bv)):
                if y < 0:
                    bad[i] = True
                    out.append(0)
                elif name == "bitwise_left_shift":
                    out.append(_i64(x << y) if y < 64 else 0)
                elif name == "bitwise_arithmetic_shift_right":
                    out.append(x >> min(y, 63))
                else:
                    out.append((x & 0xFFFFFFFFFFFFFFFF) >> y
                               if y < 64 else 0)
            if bad.any():
                m = bad if m is None else (m | bad)
            return (np.array([_i64(x) for x in out], dtype=np.int64), m)
        ops_map = {
            "bitwise_and": lambda x, y: x & y,
            "bitwise_or": lambda x, y: x | y,
            "bitwise_xor": lambda x, y: x ^ y,
        }
        fn = ops_map[name]
        return (np.array([_i64(fn(x, y)) for x, y in zip(av, bv)],
                         dtype=np.int64), m)
    raise NotImplementedError(f"reference fn {name}")


def _i64(x: int) -> int:
    """Wrap to signed 64-bit (python ints are unbounded)."""
    x &= 0xFFFFFFFFFFFFFFFF
    return x - (1 << 64) if x >= (1 << 63) else x


def _eval_string_breadth(name: str, expr: CallExpression, t: Table) -> Col:
    """regexp / URL / JSON / split scalar functions: row-at-a-time over
    python strings, sharing the per-entry kernels with the engine's
    dictionary path (exec/lowering.py — both sides wrap the same stdlib
    primitives, like both reference engines wrap the same libc)."""
    from .lowering import STRING_TO_STRING as _STRING_TO_STRING
    from .lowering import STRING_TO_VALUE as _STRING_TO_VALUE
    args = expr.arguments
    v, m = _eval(args[0], t)
    extra = [a.value for a in args[1:]]
    if name in _STRING_TO_VALUE:
        fn, dtype = _STRING_TO_VALUE[name]
        raw = [fn(str(x), *extra) for x in v]
        nulls = np.array([r is None for r in raw])
        out = np.array([0 if r is None else r for r in raw], dtype=dtype)
        if nulls.any():
            m = nulls if m is None else (m | nulls)
        return (out, m)
    fn = _STRING_TO_STRING[name]
    raw = [fn(str(x), *extra) for x in v]
    nulls = np.array([r is None for r in raw])
    out = np.array(["" if r is None else r for r in raw], dtype=object)
    if nulls.any():
        m = nulls if m is None else (m | nulls)
    return (out, m)


def _ref_pad(s: str, extra, left: bool) -> str:
    """Presto lpad/rpad: truncate to n when already longer, else pad with
    the fill string repeated from its start."""
    n = int(extra[0])
    fill = str(extra[1]) if len(extra) > 1 else " "
    if len(s) >= n:
        return s[:n]
    pad = (fill * (n - len(s)))[:n - len(s)]
    return pad + s if left else s + pad


import math as _m  # noqa: E402

_REF_DOUBLE_FNS = {
    "sqrt": _m.sqrt, "exp": _m.exp, "ln": _m.log, "log2": _m.log2,
    "log10": _m.log10, "sin": _m.sin, "cos": _m.cos, "tan": _m.tan,
    "asin": _m.asin, "acos": _m.acos, "atan": _m.atan,
    "cbrt": lambda x: _m.copysign(abs(x) ** (1 / 3), x),
    "degrees": _m.degrees, "radians": _m.radians, "power": _m.pow,
}


def _eval_array_fn(name: str, expr: CallExpression, t: Table) -> Col:
    """Array functions over object arrays of python tuples (independent of
    the engine's fixed-width device layout).  Subscript relaxes Presto's
    out-of-bounds ERROR to NULL, matching the engine (element_at
    semantics)."""
    args = expr.arguments
    if name == "array_constructor":
        items = [_eval(a, t) for a in args]
        out = np.empty(t.n, dtype=object)
        for i in range(t.n):
            out[i] = tuple(
                None if (m is not None and m[i]) else v[i]
                for v, m in items)
        return (out, None)
    if name == "repeat":
        x = _eval(args[0], t)
        counts = _eval(args[1], t)[0]
        out = np.empty(t.n, dtype=object)
        for i in range(t.n):
            # negative counts clamp to empty (engine mirror, lowering.py)
            out[i] = (x[0][i],) * max(int(counts[i]), 0)
        return (out, x[1])
    if name == "sequence":
        lo = _eval(args[0], t)[0]
        hi = _eval(args[1], t)[0]
        step = _eval(args[2], t)[0] if len(args) > 2 else np.ones(t.n)
        out = np.empty(t.n, dtype=object)
        for i in range(t.n):
            s = int(step[i])
            out[i] = tuple(range(int(lo[i]),
                                 int(hi[i]) + (1 if s > 0 else -1), s))
        return (out, None)
    arr, am = _eval(args[0], t)
    if name == "cardinality":
        return (np.array([0 if v is None else len(v) for v in arr],
                         dtype=np.int64), am)
    if name in ("subscript", "element_at"):
        idx, im = _eval(args[1], t)
        out = np.zeros(t.n, dtype=object)
        nulls = np.zeros(t.n, dtype=bool)
        for i in range(t.n):
            if (am is not None and am[i]) or (im is not None and im[i]):
                nulls[i] = True
                continue
            k = int(idx[i])
            a = arr[i]
            if a is not None and name == "element_at" and k < 0:
                k = len(a) + k + 1      # element_at(-n): from the end
            if a is None or k < 1 or k > len(a):
                nulls[i] = True
            else:
                out[i] = a[k - 1]
        return (out, nulls)
    if name == "contains":
        x, xm = _eval(args[1], t)
        hit = np.array([False if a is None else (x[i] in a)
                        for i, a in enumerate(arr)])
        m = am
        if xm is not None:
            m = xm if m is None else (m | xm)
        return (hit, m)
    if name in ("array_max", "array_min"):
        f = max if name == "array_max" else min
        out = np.zeros(t.n, dtype=object)
        nulls = np.zeros(t.n, dtype=bool)
        for i, a in enumerate(arr):
            if a is None or (am is not None and am[i]) or not len(a):
                nulls[i] = True
            else:
                out[i] = f(a)
        return (out, nulls)
    if name == "array_position":
        x, xm = _eval(args[1], t)
        out = np.zeros(t.n, dtype=np.int64)
        for i, a in enumerate(arr):
            if a is not None:
                for j, v in enumerate(a):
                    if v == x[i]:
                        out[i] = j + 1
                        break
        m = am
        if xm is not None:
            m = xm if m is None else (m | xm)
        return (out, m)
    raise NotImplementedError(name)


def _exec_UnnestNode(node: P.UnnestNode) -> Table:
    """One row per zipped element position, source columns replicated
    (UnnestOperator.java semantics: multiple arrays align by position,
    shorter ones null-extended)."""
    src = _exec(node.source)
    rep = [v.name for v in node.replicate_variables]
    arrays = [(av.name, elems[0].name)
              for av, elems in node.unnest_variables]
    take: List[int] = []
    elem_cols = {en: [] for _an, en in arrays}
    elem_nulls = {en: [] for _an, en in arrays}
    ords: List[int] = []
    for i in range(src.n):
        rowlen = 0
        vals = {}
        for an, en in arrays:
            v, m = src.cols[an]
            a = None if (m is not None and m[i]) else v[i]
            vals[en] = a
            rowlen = max(rowlen, 0 if a is None else len(a))
        for j in range(rowlen):
            take.append(i)
            ords.append(j + 1)
            for _an, en in arrays:
                a = vals[en]
                if a is None or j >= len(a):
                    elem_cols[en].append(0)
                    elem_nulls[en].append(True)
                else:
                    elem_cols[en].append(a[j])
                    elem_nulls[en].append(False)
    idx = np.array(take, dtype=np.int64)
    cols = {}
    for name in rep:
        v, m = src.cols[name]
        cols[name] = (v[idx], None if m is None else m[idx])
    for _an, en in arrays:
        vals = np.array(elem_cols[en], dtype=object)
        nulls = np.array(elem_nulls[en], dtype=bool)
        cols[en] = (vals, nulls if nulls.any() else None)
    if node.ordinality_variable is not None:
        cols[node.ordinality_variable.name] = (
            np.array(ords, dtype=np.int64), None)
    return Table(cols, len(idx))


def _eval_date_fn(name: str, expr: CallExpression, t: Table) -> Col:
    """Date functions via python's datetime — an implementation independent
    of the engine's integer civil-calendar kernels, so differential tests
    catch either side's mistakes."""
    import datetime as _dt
    args = expr.arguments
    epoch = _dt.date(1970, 1, 1).toordinal()

    def to_date(days):
        return _dt.date.fromordinal(int(days) + epoch)

    if name in ("day_of_week", "day_of_year", "week"):
        v, m = _eval(args[0], t)
        if name == "day_of_week":
            out = [to_date(x).isoweekday() for x in v]
        elif name == "day_of_year":
            out = [to_date(x).timetuple().tm_yday for x in v]
        else:
            out = [to_date(x).isocalendar()[1] for x in v]
        return (np.array(out, dtype=np.int64), m)
    unit = str(args[0].value).lower()
    if name == "date_trunc":
        v, m = _eval(args[1], t)

        def trunc(days):
            d = to_date(days)
            if unit == "day":
                pass
            elif unit == "week":
                d = d - _dt.timedelta(days=d.weekday())
            elif unit == "month":
                d = d.replace(day=1)
            elif unit == "quarter":
                d = d.replace(month=((d.month - 1) // 3) * 3 + 1, day=1)
            elif unit == "year":
                d = d.replace(month=1, day=1)
            return d.toordinal() - epoch
        return (np.array([trunc(x) for x in v], dtype=np.int64), m)
    if name == "date_add":
        nv, nm = _eval(args[1], t)
        v, m = _eval(args[2], t)
        mm = m if nm is None else (nm if m is None else (m | nm))

        def add(days, n):
            n = int(n)
            if unit == "day":
                return int(days) + n
            if unit == "week":
                return int(days) + 7 * n
            d = to_date(days)
            months = n * {"month": 1, "quarter": 3, "year": 12}[unit]
            total = d.month - 1 + months
            y, mo = d.year + total // 12, total % 12 + 1
            import calendar
            day = min(d.day, calendar.monthrange(y, mo)[1])
            return _dt.date(y, mo, day).toordinal() - epoch
        return (np.array([add(x, n) for x, n in zip(v, nv)],
                         dtype=np.int64), mm)
    # date_diff
    av, am = _eval(args[1], t)
    bv, bm = _eval(args[2], t)
    mm = am if bm is None else (bm if am is None else (am | bm))

    def diff(a, b):
        if unit == "day":
            return int(b) - int(a)
        if unit == "week":
            d = int(b) - int(a)
            return d // 7 if d >= 0 else -((-d) // 7)
        da, db = to_date(a), to_date(b)
        months = (db.year * 12 + db.month) - (da.year * 12 + da.month)
        if months > 0 and db.day < da.day:
            months -= 1
        elif months < 0 and db.day > da.day:
            months += 1
        den = {"month": 1, "quarter": 3, "year": 12}[unit]
        return months // den if months >= 0 else -((-months) // den)
    return (np.array([diff(a, b) for a, b in zip(av, bv)],
                     dtype=np.int64), mm)


def _round_to(value: int, frm: int, to: int) -> int:
    if to == frm:
        return value
    if to > frm:
        return value * 10**(to - frm)
    den = 10**(frm - to)
    q = (abs(value) + den // 2) // den
    return q if value >= 0 else -q


def _eval_cast(arg: RowExpression, to: Type, t: Table) -> Col:
    v, m = _eval(arg, t)
    frm = arg.type
    if isinstance(to, DoubleType):
        s = _scale_factor(arg)
        return (np.array([float(x) / 10**s for x in v.tolist()],
                         dtype=np.float64), m)
    if isinstance(to, DecimalType):
        if isinstance(frm, DecimalType):
            return (_to_scale(v, frm.scale, to.scale), m)
        if isinstance(frm, (DoubleType, RealType)):
            return (np.array([_round_to(int(round(float(x) * 10**to.scale)), to.scale, to.scale)
                              for x in v.tolist()], dtype=object), m)
        return (np.array([int(x) * 10**to.scale for x in v.tolist()],
                         dtype=object), m)
    if to.signature in ("bigint", "integer"):
        if isinstance(frm, DecimalType):
            return (_to_scale(v, frm.scale, 0), m)
        return (v.astype(np.int64), m)
    if isinstance(to, (VarcharType, CharType)):
        return (np.array([str(x) for x in v], dtype=object), m)
    raise NotImplementedError(f"reference cast {frm} -> {to}")


def _eval_special(expr: SpecialFormExpression, t: Table) -> Col:
    form = expr.form
    args = expr.arguments
    if form == "AND":
        va, ma = _eval(args[0], t)
        vb, mb = _eval(args[1], t)
        a = va.astype(bool)
        b = vb.astype(bool)
        an = ma if ma is not None else np.zeros(t.n, bool)
        bn = mb if mb is not None else np.zeros(t.n, bool)
        value = (a | an) & (b | bn)
        nulls = value & (an | bn)
        has = ma is not None or mb is not None
        return ((value & ~nulls) if has else (a & b), nulls if has else None)
    if form == "OR":
        va, ma = _eval(args[0], t)
        vb, mb = _eval(args[1], t)
        a, b = va.astype(bool), vb.astype(bool)
        an = ma if ma is not None else np.zeros(t.n, bool)
        bn = mb if mb is not None else np.zeros(t.n, bool)
        definite = (a & ~an) | (b & ~bn)
        nulls = ~definite & (an | bn)
        has = ma is not None or mb is not None
        return (definite if has else (a | b), nulls if has else None)
    if form == "IS_NULL":
        v, m = _eval(args[0], t)
        return ((m if m is not None else np.zeros(t.n, bool)).copy(), None)
    if form == "IN":
        v, m = _eval(args[0], t)
        vals = {constant_device_value(a.value, args[0].type) for a in args[1:]}
        if v.dtype == object and len(v) and isinstance(v[0], str):
            vals = {str(x) for x in vals}
            return (np.array([x in vals for x in v]), m)
        sa = _scale_factor(args[0])
        return (np.array([x in vals for x in v.tolist()]), m)
    if form == "IF":
        c, cm = _eval(args[0], t)
        tv, tm = _eval(args[1], t)
        fv, fm = _eval(args[2], t)
        pred = c.astype(bool)
        if cm is not None:
            pred = pred & ~cm
        out = np.where(pred, tv, fv)
        m = None
        if tm is not None or fm is not None:
            m = np.where(pred,
                         tm if tm is not None else False,
                         fm if fm is not None else False)
        return (out, m)
    if form == "COALESCE":
        v, m = _eval(args[0], t)
        out_v, out_m = v.copy(), (m.copy() if m is not None
                                  else np.zeros(t.n, bool))
        for a in args[1:]:
            av, am = _eval(a, t)
            take = out_m
            out_v = np.where(take, av, out_v)
            out_m = take & (am if am is not None else np.zeros(t.n, bool))
        return (out_v, out_m if out_m.any() else None)
    if form == "NULL_IF":
        av, am = _eval(args[0], t)
        bv, bm = _eval(args[1], t)
        eq = av == bv
        if bm is not None:
            eq = eq & ~bm
        if am is not None:
            eq = eq & ~am
        m = eq if am is None else (am | eq)
        return (av, m)
    raise NotImplementedError(f"reference special {form}")
