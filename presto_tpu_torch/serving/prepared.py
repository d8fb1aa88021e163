"""Prepared-statement registry (a host copy of
presto_tpu/serving/prepared.py; the port's own process-global registry).

The protocol is stateless like the reference's (PreparedStatement headers,
presto-client StatementClient): every request carries the session's
prepared statements as `X-Presto-Prepared-Statement: name=urlencoded-sql`
headers, PREPARE answers with `X-Presto-Added-Prepare`, DEALLOCATE with
`X-Presto-Deallocated-Prepare`.  What this process-global registry adds is
the SERVER-side memo per statement TEXT: the parsed AST (parse once per
process, not per request) and — after the first successful execution — the
fast-path record mapping USING positions onto the canonical cache
template's parameter slots, so a repeat EXECUTE with different constants
skips parse→plan→optimize entirely and goes straight to the plan cache.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from .metrics import SERVING_METRICS

_MAX_STATEMENTS = 256


@dataclass
class FastPath:
    """Everything needed to rebuild a plan-cache key + parameter vector
    from raw USING values, without planning.  `slots[i]` is
    (origin, type, fixed_value): origin None means the slot's value is a
    fixed literal of the statement (recorded from the first run); an
    integer origin binds USING position `origin` coerced to the slot
    type."""
    template_key: str                  # structural key of the template
    slots: List[Tuple[Optional[int], Any, Any]]

    def bind(self, raw_values: List[Any]) -> List[Any]:
        """Raw USING values (plan-unit python literals) -> slot values, in
        slot order.  Raises canonical.BindError on any mismatch."""
        from ..sql.canonical import BindError, bind_literal
        out = []
        for origin, typ, fixed in self.slots:
            if origin is None:
                out.append(fixed)
            else:
                if origin >= len(raw_values):
                    raise BindError(f"missing value for ?{origin + 1}")
                out.append(bind_literal(raw_values[origin], typ))
        return out


@dataclass
class PreparedStatement:
    text: str
    statement: Any                      # parsed inner AST (parser.Node)
    param_count: int
    fast: Optional[FastPath] = None
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def record_fast_path(self, fast: FastPath) -> None:
        with self._lock:
            if self.fast is None:
                self.fast = fast


class PreparedRegistry:
    """text -> PreparedStatement memo (LRU, process-global).  Session
    scoping stays with the header map / dbapi connection; this only
    deduplicates parse work and carries fast-path records across
    requests."""

    def __init__(self, max_statements: int = _MAX_STATEMENTS):
        self._lock = threading.Lock()
        self._by_text: "OrderedDict[str, PreparedStatement]" = OrderedDict()
        self.max_statements = max_statements

    def get_or_parse(self, text: str) -> PreparedStatement:
        with self._lock:
            ps = self._by_text.get(text)
            if ps is not None:
                self._by_text.move_to_end(text)
                return ps
        # parse outside the lock (a slow parse must not serialize lookups)
        from ..sql import parser as A
        sub = A.Parser(text)
        stmt = sub.parse()
        ps = PreparedStatement(text, stmt, sub._param_count)
        with self._lock:
            cur = self._by_text.get(text)
            if cur is not None:
                self._by_text.move_to_end(text)
                return cur
            self._by_text[text] = ps
            while len(self._by_text) > self.max_statements:
                self._by_text.popitem(last=False)
            SERVING_METRICS.incr("prepared_registered")
            return ps

    def clear(self) -> None:
        with self._lock:
            self._by_text.clear()

    def invalidate_fast_paths(self) -> None:
        """DDL: recorded template keys may point at dropped tables; keep
        the parse memo, drop the binding records."""
        with self._lock:
            for ps in self._by_text.values():
                ps.fast = None

    def info(self) -> dict:
        with self._lock:
            return {
                "statements": len(self._by_text),
                "fastPaths": sum(1 for p in self._by_text.values()
                                 if p.fast is not None),
            }


PREPARED_REGISTRY = PreparedRegistry()
