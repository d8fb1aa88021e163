"""Device-memory accounting (the accounting half of
presto_tpu/exec/memory.py).

`MemoryPool` is the worker pool's byte accounting: reservations against
an optional budget, with the peak tracked.  `MemoryContext` is one node
of the query -> task -> operator tree: reservations bubble up to the
root, and a root `max_bytes` is the `query.max-memory` ceiling, whose
breach is the typed, non-retryable user error.  Revocable reservations,
arbitration and spill are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from ..common.locks import OrderedLock


class MemoryExceededError(RuntimeError):
    """Pool pressure the engine could not absorb (reference
    EXCEEDED_LOCAL_MEMORY_LIMIT)."""


class QueryMemoryLimitExceededError(MemoryExceededError):
    """The `query.max-memory` limit: the query asked for more than its
    configured ceiling (reference EXCEEDED_GLOBAL_MEMORY_LIMIT)."""

    error_type = "USER_ERROR"
    error_code = "EXCEEDED_MEMORY_LIMIT"

    def __init__(self, used: int, requested: int, limit: int,
                 context: str = ""):
        super().__init__(
            f"[USER_ERROR] EXCEEDED_MEMORY_LIMIT: query memory "
            f"{used} + {requested} bytes exceeds query.max-memory "
            f"{limit} bytes" + (f" (context {context})" if context else ""))
        self.used = used
        self.requested = requested
        self.limit = limit


class MemoryPool:
    """Byte accounting for device materializations.  budget=None means
    unlimited (accounting only; the peak is still tracked)."""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self.reserved = 0
        self.peak = 0
        self.over_free_count = 0
        self._lock = OrderedLock("memory-pool", 40, reentrant=True)

    @property
    def limited(self) -> bool:
        return self.budget is not None

    def try_reserve(self, n: int) -> bool:
        with self._lock:
            if self.budget is not None and self.reserved + n > self.budget:
                return False
            self.reserved += n
            self.peak = max(self.peak, self.reserved)
            return True

    def reserve(self, n: int) -> None:
        if not self.try_reserve(n):
            raise MemoryExceededError(
                f"memory budget exceeded: reserved {self.reserved} + {n} "
                f"> {self.budget} bytes")

    def free(self, n: int) -> None:
        with self._lock:
            if n > self.reserved:
                # an over-free means a reservation was double-freed: clamp,
                # but count it so the leak is visible
                self.over_free_count += 1
                n = self.reserved
            self.reserved -= n


class MemoryContext:
    """One node of the query -> task -> operator context tree; duck-types
    the MemoryPool reservation surface."""

    def __init__(self, pool: MemoryPool, name: str = "query",
                 parent: Optional["MemoryContext"] = None,
                 max_bytes: Optional[int] = None):
        self.pool = pool
        self.name = name
        self.parent = parent
        self.max_bytes = max_bytes
        self.reserved = 0
        self.peak = 0

    @property
    def budget(self):
        return self.pool.budget

    @property
    def limited(self) -> bool:
        """True when the pool carries a budget or this context (or an
        ancestor) carries a query.max-memory ceiling."""
        if self.pool.budget is not None:
            return True
        node = self
        while node is not None:
            if node.max_bytes is not None:
                return True
            node = node.parent
        return False

    def _apply_up(self, n: int) -> None:
        node = self
        while node is not None:
            node.reserved += n
            node.peak = max(node.peak, node.reserved)
            node = node.parent

    def try_reserve(self, n: int) -> bool:
        with self.pool._lock:
            node = self
            while node is not None:
                if node.max_bytes is not None \
                        and node.reserved + n > node.max_bytes:
                    raise QueryMemoryLimitExceededError(
                        node.reserved, n, node.max_bytes, context=node.name)
                node = node.parent
            if not self.pool.try_reserve(n):
                return False
            self._apply_up(n)
            return True

    def reserve(self, n: int) -> None:
        if not self.try_reserve(n):
            raise MemoryExceededError(
                f"memory budget exceeded: reserved {self.pool.reserved} + "
                f"{n} > {self.pool.budget} bytes")

    def free(self, n: int) -> None:
        with self.pool._lock:
            self.pool.free(n)
            self._apply_up(-min(n, self.reserved))


def batch_bytes(batch) -> int:
    """Device bytes of a Batch: every column's values and NULL mask, and
    the row mask."""
    n = batch.mask.numel() * batch.mask.element_size()
    for c in batch.columns.values():
        n += c.values.numel() * c.values.element_size()
        if c.nulls is not None:
            n += c.nulls.numel() * c.nulls.element_size()
    return n
