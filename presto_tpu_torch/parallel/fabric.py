"""Exchange fabric selection + per-fabric shuffle metrics.

A remote-exchange edge between two fragments can ride one of two
fabrics (SURVEY.md §5.8, the PAPER.md "partitioned-exchange shuffles
over ICI" north star):

  http  the ExchangeClient pull shuffle: producer tasks serialize
        pages into output buffers, consumers pull over HTTP.  Works
        across hosts/pods and for every partitioning handle.
  ici   a jitted all_to_all over the device mesh
        (parallel/exchange.py): rows never leave HBM.  Requires a
        hash-partitioned edge whose producer AND consumer stages are
        co-located on one mesh with tasks pinned 1:1 to devices.

`exchange.fabric` (ExecutionConfig.exchange_fabric, session property
`exchange_fabric`) requests `auto | http | ici` per query; `auto` picks
ICI wherever the edge is eligible and the scheduler can CHOOSE task
counts equal to the mesh size, falling back to HTTP otherwise — so one
plan may mix fabrics (intra-mesh edges on ICI, gather / broadcast /
cross-host edges on HTTP).

This module is import-light (no jax): the fragmenter, scheduler,
checker, and EXPLAIN all share `resolve_fabric` so plan annotation,
runtime selection, and validation cannot drift.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..common.locks import OrderedLock

FABRIC_AUTO = "auto"
FABRIC_HTTP = "http"
FABRIC_ICI = "ici"
FABRICS = (FABRIC_AUTO, FABRIC_HTTP, FABRIC_ICI)

# fragment partitionings an ICI endpoint stage may have (spi/plan.py
# *_DISTRIBUTION values): its task count must be the scheduler's to
# choose, and SINGLE fragments are pinned to one task (values /
# enforce-single-row / final gather semantics)
_MULTI_TASK = ("SOURCE", "FIXED_HASH")


def resolve_fabric(requested: Optional[str], *, handle: str,
                   producer_partitioning: str,
                   consumer_partitioning: str,
                   mesh_size: int,
                   batch_mode: bool = False) -> Tuple[str, str]:
    """Resolve one remote-exchange edge to a concrete fabric.

    Returns (fabric, reason); fabric is FABRIC_HTTP or FABRIC_ICI, the
    reason says why (surfaced in EXPLAIN / fallback stats).  `requested`
    is the edge annotation or config value (None == auto).
    """
    req = requested or FABRIC_AUTO
    if req == FABRIC_HTTP:
        return FABRIC_HTTP, "requested"
    if handle != "FIXED_HASH":
        return FABRIC_HTTP, f"{handle} edge (ICI is hash-only)"
    if mesh_size < 2:
        return FABRIC_HTTP, "no mesh"
    if batch_mode:
        return FABRIC_HTTP, "batch mode needs durable shuffle files"
    if producer_partitioning not in _MULTI_TASK:
        return FABRIC_HTTP, (f"{producer_partitioning} producer cannot "
                             f"pin {mesh_size} tasks to the mesh")
    if consumer_partitioning not in _MULTI_TASK:
        return FABRIC_HTTP, (f"{consumer_partitioning} consumer cannot "
                             f"pin {mesh_size} tasks to the mesh")
    return FABRIC_ICI, ("requested" if req == FABRIC_ICI
                        else "mesh-eligible hash edge")


class FabricMetrics:
    """Process-wide per-fabric shuffle counters — the stats-parity
    surface of the ICI path next to worker/exchange.py ExchangeMetrics
    (which meters the HTTP client).  Snapshot keys per fabric:

      exchanges        completed exchange edges (stage executions)
      chunks           collective dispatches (== exchanges for the
                       unchunked page path)
      bytes_moved      payload bytes through the fabric (wire bytes for
                       http, device shard bytes for ici)
      host_bytes       bytes that crossed device->host or host->host —
                       the ICI win: ~0, vs everything for http
      exchange_wall_s  producer-side shuffle wall (dispatch for ici,
                       partition+split for the in-process page path)
      compute_wall_s   consumer-side drain wall (first read ->
                       exhaustion, compute between chunks included)
      wait_wall_s      consumer-side time blocked on data not yet ready
      fallbacks        edges demoted to http (ineligible / metadata
                       mismatch / forced)
    """

    _FIELDS = ("exchanges", "chunks", "bytes_moved", "host_bytes",
               "exchange_wall_s", "compute_wall_s", "wait_wall_s",
               "fallbacks")

    def __init__(self):
        # rank 100: metrics registries are leaf locks
        self._lock = OrderedLock("metrics:fabric", 100)  # lint: guarded-by(_lock)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._by_fabric = {
                FABRIC_HTTP: {f: 0.0 for f in self._FIELDS},
                FABRIC_ICI: {f: 0.0 for f in self._FIELDS},
            }

    def record(self, fabric: str, **deltas) -> None:
        with self._lock:
            m = self._by_fabric[fabric]
            for k, v in deltas.items():
                m[k] += v

    def overlap_fraction(self, fabric: str) -> float:
        """1 - wait/compute: the share of consumer drain time the
        collective (or pull) was hidden behind compute — same shape as
        bench.py's HTTP overlap_fraction."""
        with self._lock:
            m = self._by_fabric[fabric]
            if m["compute_wall_s"] <= 0:
                return 0.0
            return max(0.0, 1.0 - m["wait_wall_s"] / m["compute_wall_s"])

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for fabric, m in self._by_fabric.items():
                d = dict(m)
                for k in ("exchanges", "chunks", "bytes_moved",
                          "host_bytes", "fallbacks"):
                    d[k] = int(d[k])
                d["overlap_fraction"] = (
                    max(0.0, 1.0 - m["wait_wall_s"] / m["compute_wall_s"])
                    if m["compute_wall_s"] > 0 else 0.0)
                out[fabric] = d
            return out

    def byte_rates(self) -> dict:
        """bytes/s through each fabric while it was actually moving data
        (bytes_moved over exchange wall) — the /v1/cluster analog of the
        reference ClusterStatsResource input/output byte rates."""
        with self._lock:
            out = {}
            for fabric, m in self._by_fabric.items():
                wall = m["exchange_wall_s"]
                out[fabric] = (m["bytes_moved"] / wall) if wall > 0 else 0.0
            return out


FABRIC_METRICS = FabricMetrics()


class IciChunkTuner:
    """Feedback controller for the chunked ICI exchange granularity.

    When `exchange.ici-chunk-rows` is left unset (ExecutionConfig value
    0), the scheduler asks this tuner for each run's chunk size and
    feeds back the observed compute/collective `overlap_fraction` from
    FABRIC_METRICS after the exchange completes.  Simple multiplicative
    feedback, clamped:

      overlap < LOW    the consumer spent a large share of its drain
                       wall BLOCKED on collectives -> halve the chunk:
                       finer chunks start compute sooner and give the
                       pipeline more in-flight collectives to hide
      overlap > HIGH   collectives are already hidden behind compute ->
                       double the chunk to amortize per-chunk dispatch
                       (fewer all_to_all launches for the same rows)

    Hysteresis between LOW and HIGH holds the size steady.  Explicit
    config values bypass the tuner entirely (properties layer rejects
    explicit values < 1, so 0 is only reachable as the default)."""

    LOW = 0.5
    HIGH = 0.9
    MIN_ROWS = 1 << 10
    MAX_ROWS = 1 << 16
    DEFAULT_ROWS = 1 << 12

    def __init__(self):
        self._lock = OrderedLock("metrics:ici-tuner", 100)  # lint: guarded-by(_lock)
        self._rows = self.DEFAULT_ROWS

    def chunk_rows(self) -> int:
        with self._lock:
            return self._rows

    def observe(self, overlap_fraction: float) -> None:
        with self._lock:
            if overlap_fraction < self.LOW:
                self._rows = max(self.MIN_ROWS, self._rows // 2)
            elif overlap_fraction > self.HIGH:
                self._rows = min(self.MAX_ROWS, self._rows * 2)

    def reset(self) -> None:
        with self._lock:
            self._rows = self.DEFAULT_ROWS


ICI_CHUNK_TUNER = IciChunkTuner()
