"""Fragment-level step sharing (the port of presto_tpu/serving/fragments.py).

The canonical PlanCache shares compiled state between executions of the
SAME whole plan.  Queries that differ above a common scan -> filter ->
project subchain would still rebuild every step's state, because a
compiler keeps its state per plan-node id.  This module is the
process-global complement: a step's compiled state keyed on the
STRUCTURAL key of the subtree it compiles (`spi.plan.structural_key` --
node ids blanked, variables renamed) plus the execution-config
fingerprint and the device, so two different plans sharing a fragment
share one artifact.  `PlanCompiler.fragment_jit` (exec/pipeline.py)
routes the scan / filter / project sites here when the `fragment_share`
config knob is on and no stage-scoped cache is installed (the
scheduler's tasks share their steps per stage instead).

What a site shares in the port is what the reference's jitted callable
holds: a filter's or projection's expressions after the string
hoister's resolution, the ExprPrograms lowered from them, and the
scan's per-chunk make closure.  Each is a pure function of its
arguments (the batch, the bound-parameter vector, the resident columns)
plus host constants fully determined by the key: the subtree's
structure (the table and its scale factor included), the config, the
device, and the first batch's column signature.  A false share would
run the wrong program; a missed share costs one rebuild.  DDL clears
the cache alongside the plan cache (runner._invalidate_plans).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from ..common.locks import OrderedLock
from .metrics import SERVING_METRICS

DEFAULT_FRAGMENT_ENTRIES = 512


class FragmentJitCache:
    def __init__(self, max_entries: int = DEFAULT_FRAGMENT_ENTRIES):
        # rank 95: SERVING_METRICS (100) is bumped while held; taken from
        # inside compiler step construction with no serving lock held
        self._lock = OrderedLock("serving-fragments", 95)  # lint: guarded-by(_lock)
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.max_entries = int(max_entries)

    def get_or_build(self, key: tuple, build: Callable):
        """Return the cached step state for `key`, building (and
        LRU-inserting) it on first sight.  `build` only assembles host
        objects (no device work), so it runs under the lock."""
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                SERVING_METRICS.incr("fragment_jit_hits")
                return fn
            fn = build()
            self._entries[key] = fn
            SERVING_METRICS.incr("fragment_jit_misses")
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            return fn

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    def info(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "maxEntries": self.max_entries}


FRAGMENT_JIT_CACHE = FragmentJitCache()
