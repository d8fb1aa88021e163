"""Adaptive query execution: runtime feedback folded back into the plan.

Three cooperating pieces (reference analogs: PrestoDB dynamic filtering
`DynamicFilterService`, `DynamicFilterSourceOperator`; history-based
optimization `HistoryBasedPlanStatisticsCalculator`):

- `DynamicFilterSummary` / `DynamicFilterCollector`: when a build-side
  stage finishes, its per-key domain (min/max always, the exact value
  set under `dynamic-filtering.max-distinct-values`) is summarized and
  collected per filter id; downstream scans consume the summary through
  `storage/pushdown.py` ``["dyn", fid, bound]`` marker entries (zone-map
  chunk prune) and a traced row filter (no recompile — bounds ride as
  jit arguments, the parameterization idiom).

- `decide_exchange`: at a stage boundary, compares the observed
  build-side row count against the fragmenter's planned estimate and
  flips a partitioned exchange to broadcast (or swaps join sides) when
  the plan-time assumption was wrong by `ADAPTIVE_RATIO` or more.

- `ADAPTIVE_METRICS`: process-wide counter registry (`/v1/metrics`
  ``presto_tpu_adaptive_*``, OTLP scrape, EXPLAIN ANALYZE footer).

Everything here is host-side and advisory: a summary that never arrives
only costs pruning opportunity (scans proceed unfiltered after the
bounded `dynamic-filtering.wait-timeout`), never correctness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..common.locks import OrderedLock

# Flip partitioned->broadcast only when the planned estimate missed by
# at least this factor AND the observed build fits the broadcast
# threshold; a mild miss is not worth re-deciding.
ADAPTIVE_RATIO = 10.0


# ---------------------------------------------------------------------------
# metrics registry (same locked-singleton shape as STORAGE_METRICS)
# ---------------------------------------------------------------------------

_ADAPTIVE_COUNTERS = (
    "filters_collected",      # summaries published by build stages
    "filters_applied",        # scans that consumed >=1 summary
    "filter_rows_in",         # rows entering runtime row filters
    "filter_rows_pruned",     # rows dropped by runtime row filters
    "filter_chunks_skipped",  # zone-map chunks skipped ONLY by dyn entries
    "filter_wait_timeouts",   # scans that gave up waiting and ran unfiltered
    "filter_late_arrivals",   # summaries delivered after the scan started
    "exchange_broadcast_flips",  # partitioned->broadcast at runtime
    "exchange_side_swaps",       # build/probe swapped at runtime
    "exchange_kept",             # boundaries inspected, plan kept
    "history_sized_queries",     # queries sized from a history record
)


class AdaptiveMetrics:
    """Locked adaptive-decision counter registry (dict-like read surface,
    mirroring storage/store.StorageMetrics)."""

    def __init__(self):
        # rank 100: metrics registries are leaf locks
        self._lock = OrderedLock("metrics:adaptive", 100)  # lint: guarded-by(_lock)
        self._values: Dict[str, int] = {k: 0 for k in _ADAPTIVE_COUNTERS}

    def reset(self) -> None:
        with self._lock:
            for k in _ADAPTIVE_COUNTERS:
                self._values[k] = 0

    def incr(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._values[name] += delta

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._values[name]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._values

    def __iter__(self):
        return iter(self.keys())

    def keys(self):
        with self._lock:
            return list(self._values)

    def items(self):
        return self.snapshot().items()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._values)


ADAPTIVE_METRICS = AdaptiveMetrics()


def reset_adaptive_metrics() -> None:
    ADAPTIVE_METRICS.reset()


# ---------------------------------------------------------------------------
# dynamic filter summaries
# ---------------------------------------------------------------------------

@dataclass
class DynamicFilterSummary:
    """Domain summary of one dynamic-filter key, as published by a
    completed build-side stage.

    `min`/`max` are None when the key column's domain could not be
    bounded (non-integer storage, empty side with no rows observed is
    min>max instead) — consumers must then keep every chunk/row.
    `values` is the exact distinct set when it fit under the collection
    cap, else None (bounds-only).  All values are host ints in STORED
    column units, the same units zone maps carry."""

    filter_id: str
    min: Optional[int] = None
    max: Optional[int] = None
    values: Optional[Tuple[int, ...]] = None
    row_count: int = 0

    @property
    def empty(self) -> bool:
        """True when the build side had no rows: every probe chunk can
        be pruned (min>max is the zone-map empty convention)."""
        return self.row_count == 0

    @property
    def bounded(self) -> bool:
        return self.min is not None and self.max is not None

    def to_dict(self) -> dict:
        d: dict = {"filterId": self.filter_id, "rowCount": self.row_count}
        if self.min is not None:
            d["min"] = int(self.min)
        if self.max is not None:
            d["max"] = int(self.max)
        if self.values is not None:
            d["values"] = [int(v) for v in self.values]
        return d

    @staticmethod
    def from_dict(d: dict) -> "DynamicFilterSummary":
        vals = d.get("values")
        return DynamicFilterSummary(
            filter_id=d["filterId"],
            min=d.get("min"), max=d.get("max"),
            values=None if vals is None else tuple(vals),
            row_count=int(d.get("rowCount", 0)))

    def merge(self, other: "DynamicFilterSummary",
              max_distinct: int) -> "DynamicFilterSummary":
        """Union of two partial summaries (two tasks of one build stage).
        Bounds widen; the exact set survives only while BOTH sides have
        one and the union stays under the cap.  An unbounded side makes
        the merge unbounded — conservatism over cleverness."""
        rows = self.row_count + other.row_count
        if self.row_count == 0:
            return DynamicFilterSummary(self.filter_id, other.min,
                                        other.max, other.values, rows)
        if other.row_count == 0:
            return DynamicFilterSummary(self.filter_id, self.min,
                                        self.max, self.values, rows)
        if not (self.bounded and other.bounded):
            return DynamicFilterSummary(self.filter_id, None, None,
                                        None, rows)
        values = None
        if self.values is not None and other.values is not None:
            u = set(self.values) | set(other.values)
            if len(u) <= max_distinct:
                values = tuple(sorted(u))
        return DynamicFilterSummary(
            self.filter_id, min(self.min, other.min),
            max(self.max, other.max), values, rows)


def summarize_key_column(filter_id: str, values, mask,
                         max_distinct: int) -> DynamicFilterSummary:
    """Summary over one host array of key values (`mask` selects live,
    non-null rows; either may be None).  Only integer-kind arrays get
    bounds — zone maps hold stored-unit ints, and float equality pruning
    is not worth the soundness analysis."""
    import numpy as np
    v = np.asarray(values)
    if mask is not None:
        v = v[np.asarray(mask, dtype=bool)]
    rows = int(v.size)
    if rows == 0:
        return DynamicFilterSummary(filter_id, row_count=0)
    if v.dtype.kind not in ("i", "u", "b"):
        return DynamicFilterSummary(filter_id, row_count=rows)
    values_out: Optional[Tuple[int, ...]] = None
    # cheap exactness probe: a full unique() on a huge build side is
    # wasted work when the cap is tiny, so bail early on the row count
    if rows <= max(max_distinct * 64, 4096):
        uniq = np.unique(v)
        if uniq.size <= max_distinct:
            values_out = tuple(int(x) for x in uniq)
    return DynamicFilterSummary(
        filter_id, int(v.min()), int(v.max()), values_out, rows)


class DynamicFilterCollector:
    """Per-query accumulation of summaries keyed by filter id, merging
    partials as build tasks complete.  Thread-safe: the in-process
    scheduler's task pool and the coordinator's status watcher both
    publish from worker threads."""

    def __init__(self, max_distinct: int = 256):
        self.max_distinct = max_distinct
        # rank 58: sits between exchange-client locks and query-history
        self._lock = OrderedLock("adaptive:df-collector", 58)  # lint: guarded-by(_lock)
        self._summaries: Dict[str, DynamicFilterSummary] = {}

    def publish(self, summary: DynamicFilterSummary) -> None:
        with self._lock:
            cur = self._summaries.get(summary.filter_id)
            self._summaries[summary.filter_id] = (
                summary if cur is None
                else cur.merge(summary, self.max_distinct))
        ADAPTIVE_METRICS.incr("filters_collected")

    def get(self, filter_id: str) -> Optional[DynamicFilterSummary]:
        with self._lock:
            return self._summaries.get(filter_id)

    def snapshot(self) -> Dict[str, DynamicFilterSummary]:
        with self._lock:
            return dict(self._summaries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._summaries)


def summaries_to_runtime(
        summaries: Dict[str, DynamicFilterSummary]) -> Dict[str, dict]:
    """The `TaskContext.dynamic_filters` / wire form: fid -> plain dict."""
    return {fid: s.to_dict() for fid, s in summaries.items()}


# ---------------------------------------------------------------------------
# exchange strategy decisions
# ---------------------------------------------------------------------------

@dataclass
class ExchangeDecision:
    """One stage-boundary re-decision, for metering and EXPLAIN."""
    node_id: str
    action: str               # "broadcast" | "swap_sides" | "keep"
    planned_rows: Optional[int]
    observed_rows: int
    detail: str = ""


def decide_exchange(planned_rows: Optional[int], observed_rows: int,
                    broadcast_threshold: int,
                    ratio: float = ADAPTIVE_RATIO) -> bool:
    """True when a PARTITIONED build side should flip to broadcast: the
    observed build fits under the broadcast threshold AND the planner's
    estimate was off by at least `ratio` (an estimate that was simply
    absent counts as wrong — the planner had nothing to stand on)."""
    if observed_rows > broadcast_threshold:
        return False
    if planned_rows is None:
        return True
    return observed_rows * ratio <= planned_rows


def decide_side_swap(left_rows: Optional[int], right_rows: Optional[int],
                     ratio: float = 2.0) -> bool:
    """True when the observed build (right) side is so much larger than
    the probe that hashing the probe instead wins.  Only INNER joins may
    act on this — LEFT/FULL pin sides by preservation semantics."""
    if left_rows is None or right_rows is None:
        return False
    return right_rows >= left_rows * ratio and right_rows > 0


@dataclass
class AdaptiveState:
    """Per-execution adaptive context threaded through the scheduler:
    the filter collector plus the decision log the EXPLAIN ANALYZE
    footer and tests read back."""
    collector: DynamicFilterCollector = field(
        default_factory=DynamicFilterCollector)
    decisions: List[ExchangeDecision] = field(default_factory=list)

    def record(self, decision: ExchangeDecision) -> None:
        self.decisions.append(decision)
        if decision.action == "broadcast":
            ADAPTIVE_METRICS.incr("exchange_broadcast_flips")
        elif decision.action == "swap_sides":
            ADAPTIVE_METRICS.incr("exchange_side_swaps")
        else:
            ADAPTIVE_METRICS.incr("exchange_kept")
