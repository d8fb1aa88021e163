"""AST thread-safety pass: guarded-by checking, blocking-under-lock,
non-blocking callbacks, and the static lock-order graph.

The port's copy of presto_tpu/analysis/concurrency.py: the same codes
and pragmas; LOCK002's device syncs are the torch ones (`.item()`,
`.cpu()`, `.synchronize()`, `torch.cuda.synchronize()`).

The worker's threaded subsystems (exchange pullers, spill staging,
telemetry flush, heartbeat detector, task reaper, spool flush
callbacks) coordinate through per-class locks whose discipline so far
lived only in comments and reviewer memory.  This pass — the static
half of `common/locks.py`'s runtime validation — walks Python source
with `ast` at CLASS granularity and flags four hazard shapes:

  LOCK001  a mutable attribute of a lock-owning class written outside
           the lock that guards it.  Guarding is DECLARED with a
           `# lint: guarded-by(<lockattr>)` annotation: on the line
           initialising `self.attr` it guards that one attribute; on
           the line declaring the lock itself it guards the whole
           class (every `self.*` write must then sit in an allowed
           context).  For the unannotated single-lock common case the
           guard is INFERRED: an attribute written in >= 2 methods,
           at least once under `with self.<lock>` and at least once
           outside, is assumed guarded and the outside writes flagged.
           Allowed contexts: `__init__`/`__new__`, lexically inside
           `with self.<lock>`, a method whose name ends `_locked`
           (runs under the caller's lock by convention), a method that
           manually acquires the lock (`self.<lock>.acquire(...)` —
           the try/finally and timed-decline shapes), or the
           `# lint: allow-unguarded` pragma on the write.
  LOCK002  a blocking call made while a lock is held (lexically inside
           `with self.<lock>`): urllib requests, an untimed zero-arg
           `.get()` / `.join()` / `.wait()` (queue pulls, thread
           joins, event waits), or a device sync (`.item()`, `.cpu()`,
           `.synchronize()`, `torch.cuda.synchronize()`).  Holding a
           mutex across an unbounded wait turns one stalled peer into a
           stalled subsystem.  `cond.wait()` ON the held condition itself is
           the sanctioned condition-variable shape and is exempt.
           Escape: `# lint: allow-blocking-under-lock`.
  LOCK003  a lock acquisition inside a callback registered as
           non-blocking.  The PR 15 arbitrator runs revoke callbacks
           while other operators wait on memory; a callback that
           blocks on a contended lock stalls arbitration for everyone
           — the implemented discipline (TaskSpool._revoke,
           PageBuffer._revoke) is a TIMED acquire that declines the
           pass.  Callback methods are found by registration
           (`self.<meth>` passed to a `register_revocable(...)` call)
           or marked explicitly with `# lint: non-blocking-callback`
           on the def line.  Inside one, a `with self.<lock>:` or an
           unbounded `self.<lock>.acquire()` is flagged; an acquire
           bounded by `timeout=` / `blocking=False` complies.
           Escape: `# lint: allow-lock-in-callback`.
  LOCK004  a cycle or rank inversion in the statically-extracted
           lock-order graph.  Lexically nested `with self.<lock>`
           blocks (and manual acquires under a held `with`) contribute
           directed edges outer->inner; locks declared as
           `OrderedLock`/`OrderedCondition` resolve to their declared
           (name, rank).  An edge from rank r to rank <= r, a
           non-reentrant self-edge, or any directed cycle across
           classes is flagged — the same inversions
           `debug.lock-validation=on` raises at runtime, caught in CI
           without needing the interleaving to happen.
           Escape: `# lint: allow-lock-order` on the inner acquisition.

Like `analysis/lint.py` the pass is a tripwire tuned to zero false
positives on the shipped tree, not a race detector: it sees lexical
structure, so a lock taken behind a method call is invisible to
LOCK004 (the runtime half covers those), and guarded-by inference
deliberately requires evidence (one guarded write) before it trusts
itself.

Run as a module (exits nonzero when any finding survives the pragmas):

    python -m presto_tpu_torch.analysis.concurrency presto_tpu_torch
"""
from __future__ import annotations

import ast
import io
import re
import sys
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .lint import LintFinding, _dotted

PRAGMA_UNGUARDED = "lint: allow-unguarded"
PRAGMA_BLOCKING = "lint: allow-blocking-under-lock"
PRAGMA_CALLBACK_MARK = "lint: non-blocking-callback"
PRAGMA_CALLBACK_ALLOW = "lint: allow-lock-in-callback"
PRAGMA_LOCK_ORDER = "lint: allow-lock-order"
_GUARDED_BY = re.compile(r"lint:\s*guarded-by\(\s*([A-Za-z_]\w*)\s*\)")

LOCK_UNGUARDED = "LOCK001"
LOCK_BLOCKING_HELD = "LOCK002"
LOCK_IN_CALLBACK = "LOCK003"
LOCK_ORDER = "LOCK004"

ALL_CONCURRENCY_CODES = (LOCK_UNGUARDED, LOCK_BLOCKING_HELD,
                         LOCK_IN_CALLBACK, LOCK_ORDER)

# constructors whose result is a mutex / condition (raw or ordered)
_LOCK_CTORS = {"Lock", "RLock", "Condition",
               "OrderedLock", "OrderedCondition"}
_REENTRANT_CTORS = {"RLock", "Condition", "OrderedCondition"}
# callback registration entry points whose function arguments must not
# block (the PR 15 arbitrator contract)
_NONBLOCKING_REGISTRARS = ("register_revocable",)
# blocking network entry points (same family as lint's SYNC005/NET001)
_BLOCKING_NET_CALLS = {"urllib.request.urlopen", "urllib.request.urlretrieve",
                       "request.urlopen", "urlopen"}
# zero-arg method calls that park the calling thread until someone else
# acts: queue pulls, thread joins, event/condition waits
_BLOCKING_METHODS = ("get", "join", "wait")
# device syncs (lint flags them on the query path; HERE the hazard is
# holding a mutex across the device round trip)
_DEVICE_SYNC_METHODS = ("item", "cpu", "synchronize")
_DEVICE_SYNC_CALLS = {"torch.cuda.synchronize"}
_LIFECYCLE_METHODS = ("__init__", "__new__", "__post_init__")


def _pragma_lines(source: str) -> Tuple[Dict[str, Set[int]],
                                        Dict[int, str]]:
    """(per-pragma line sets, guarded-by line -> lock attr).  Pragmas
    are NOT interchangeable across codes — each check consults only its
    own set, so an allow-unguarded can't silence a lock-order edge."""
    allowed: Dict[str, Set[int]] = {
        PRAGMA_UNGUARDED: set(), PRAGMA_BLOCKING: set(),
        PRAGMA_CALLBACK_MARK: set(), PRAGMA_CALLBACK_ALLOW: set(),
        PRAGMA_LOCK_ORDER: set()}
    guarded_by: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            for pragma, lines in allowed.items():
                if pragma in tok.string:
                    lines.add(tok.start[0])
            m = _GUARDED_BY.search(tok.string)
            if m:
                guarded_by[tok.start[0]] = m.group(1)
    except tokenize.TokenizeError:
        pass
    return allowed, guarded_by


def _stmt_lines(node: ast.AST) -> range:
    first = getattr(node, "lineno", 0)
    last = getattr(node, "end_lineno", first) or first
    return range(first, last + 1)


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a plain `self.x` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _LockDecl:
    """One lock attribute of one class: its constructor kind and, when
    declared as OrderedLock/OrderedCondition, its (name, rank)."""

    __slots__ = ("cls", "attr", "name", "rank", "reentrant")

    def __init__(self, cls: str, attr: str, name: Optional[str],
                 rank: Optional[int], reentrant: bool):
        self.cls = cls
        self.attr = attr
        self.name = name
        self.rank = rank
        self.reentrant = reentrant

    def node_id(self) -> str:
        """Graph node identity: the declared lock NAME when ranked (so
        the same logical lock matches across classes), else the
        class-qualified attribute (so anonymous `self._lock`s in
        different classes never alias)."""
        return self.name if self.name else f"{self.cls}.{self.attr}"


def _parse_lock_ctor(cls: str, attr: str,
                     value: ast.AST) -> Optional[_LockDecl]:
    """A `self.attr = <lock ctor>(...)` (or dataclass
    `attr: T = field(default_factory=<ctor>)`) -> _LockDecl, else None."""
    if not isinstance(value, ast.Call):
        return None
    ctor = _dotted(value.func).rsplit(".", 1)[-1]
    if ctor == "field":
        for kw in value.keywords:
            if kw.arg == "default_factory":
                inner = _dotted(kw.value).rsplit(".", 1)[-1]
                if inner in _LOCK_CTORS:
                    return _LockDecl(cls, attr, None, None,
                                     inner in _REENTRANT_CTORS)
        return None
    if ctor not in _LOCK_CTORS:
        return None
    name = rank = None
    reentrant = ctor in _REENTRANT_CTORS
    if ctor in ("OrderedLock", "OrderedCondition"):
        args = list(value.args)
        if args and isinstance(args[0], ast.Constant) \
                and isinstance(args[0].value, str):
            name = args[0].value
        if len(args) > 1 and isinstance(args[1], ast.Constant) \
                and isinstance(args[1].value, int):
            rank = args[1].value
        for kw in value.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = kw.value.value
            elif kw.arg == "rank" and isinstance(kw.value, ast.Constant):
                rank = kw.value.value
            elif kw.arg == "reentrant" \
                    and isinstance(kw.value, ast.Constant):
                reentrant = bool(kw.value.value) \
                    or ctor == "OrderedCondition"
    return _LockDecl(cls, attr, name, rank, reentrant)


class _Edge:
    """One lock-order edge outer->inner extracted from a lexically
    nested acquisition."""

    __slots__ = ("outer", "inner", "path", "line", "allowed")

    def __init__(self, outer: _LockDecl, inner: _LockDecl, path: str,
                 line: int, allowed: bool):
        self.outer = outer
        self.inner = inner
        self.path = path
        self.line = line
        self.allowed = allowed


class _Write:
    __slots__ = ("attr", "node", "held", "method")

    def __init__(self, attr: str, node: ast.AST, held: Tuple[str, ...],
                 method: str):
        self.attr = attr
        self.node = node
        self.held = held
        self.method = method


class _ClassScan:
    """Everything one pass over a ClassDef collects: lock declarations,
    guarded-by annotations, attribute writes with their held-lock
    context, blocking calls under locks, callback registrations, and
    lock-order edges."""

    def __init__(self, module: "_ModuleScan", node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.locks: Dict[str, _LockDecl] = {}
        self.guarded: Dict[str, str] = {}      # attr -> guarding lock attr
        self.class_guard: Optional[str] = None  # whole-class guard attr
        self.writes: List[_Write] = []
        self.acquires: Dict[str, Set[str]] = {}  # method -> lock attrs
        self.callback_methods: Set[str] = set()
        self.methods: Dict[str, ast.FunctionDef] = {}

    # -- pass A: declarations ------------------------------------------------
    def collect_declarations(self) -> None:
        for stmt in self.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
                if self._marked_callback(stmt):
                    self.callback_methods.add(stmt.name)
                for sub in ast.walk(stmt):
                    self._note_assignment(sub)
                    self._note_registration(sub)
            else:
                self._note_assignment(stmt)
        # a guarded-by on the lock's own declaration line guards the
        # whole class
        for attr, guard in list(self.guarded.items()):
            if attr == guard and attr in self.locks:
                self.class_guard = guard
                del self.guarded[attr]

    def _marked_callback(self, fn) -> bool:
        first = fn.body[0].lineno if fn.body else fn.lineno
        marks = self.module.allowed[PRAGMA_CALLBACK_MARK]
        return any(ln in marks for ln in range(fn.lineno, first + 1))

    def _note_assignment(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            return
        for tgt in targets:
            attr = _self_attr(tgt)
            if attr is None and isinstance(tgt, ast.Name) \
                    and stmt in self.node.body:
                attr = tgt.id     # dataclass-style class-level field
            if attr is None:
                continue
            decl = _parse_lock_ctor(self.name, attr, value)
            if decl is not None:
                self.locks[attr] = decl
            for ln in _stmt_lines(stmt):
                if ln in self.module.guarded_lines:
                    self.guarded[attr] = self.module.guarded_lines[ln]
                    break

    def _note_registration(self, node: ast.AST) -> None:
        if not isinstance(node, ast.Call):
            return
        fn = _dotted(node.func).rsplit(".", 1)[-1]
        if fn not in _NONBLOCKING_REGISTRARS:
            return
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            meth = _self_attr(arg)
            if meth is not None:
                self.callback_methods.add(meth)

    # -- pass B: method bodies ------------------------------------------------
    def scan_methods(self) -> None:
        for name, fn in self.methods.items():
            self.acquires.setdefault(name, set())
            self._walk(fn.body, name, held=[])

    def _walk(self, stmts: Sequence[ast.stmt], method: str,
              held: List[str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                pushed = 0
                for item in stmt.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in self.locks:
                        self._note_edge(held, attr, item.context_expr)
                        held.append(attr)
                        pushed += 1
                    else:
                        self._scan_expr(item.context_expr, method, held)
                self._walk(stmt.body, method, held)
                for _ in range(pushed):
                    held.pop()
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def's body runs later, not under these locks
                self._walk(stmt.body, method, held=[])
            elif isinstance(stmt, ast.ClassDef):
                continue
            else:
                for tgt, kind in self._write_targets(stmt):
                    self.writes.append(
                        _Write(tgt, stmt, tuple(held), method))
                for sub_body in self._nested_bodies(stmt):
                    self._walk(sub_body, method, held)
                self._scan_stmt_exprs(stmt, method, held)

    @staticmethod
    def _nested_bodies(stmt: ast.stmt) -> List[Sequence[ast.stmt]]:
        bodies = []
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                bodies.append(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            bodies.append(handler.body)
        return bodies

    def _write_targets(self, stmt: ast.stmt) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []

        def _target(tgt: ast.AST, kind: str) -> None:
            if isinstance(tgt, (ast.Tuple, ast.List)):
                for elt in tgt.elts:
                    _target(elt, kind)
                return
            if isinstance(tgt, ast.Starred):
                _target(tgt.value, kind)
                return
            if isinstance(tgt, ast.Subscript):
                tgt = tgt.value
            attr = _self_attr(tgt)
            if attr is not None:
                out.append((attr, kind))

        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                _target(tgt, "assign")
        elif isinstance(stmt, ast.AugAssign):
            _target(stmt.target, "augassign")
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            _target(stmt.target, "assign")
        return out

    def _scan_stmt_exprs(self, stmt: ast.stmt, method: str,
                         held: List[str]) -> None:
        """Scan the expressions hanging off one statement (not its
        nested statement bodies, which _walk recurses into itself)."""
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.expr):
                self._scan_expr(value, method, held)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self._scan_expr(v, method, held)

    def _scan_expr(self, expr: ast.AST, method: str,
                   held: List[str]) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                self._check_call(sub, method, held)

    # -- hazards at a call site ------------------------------------------------
    def _check_call(self, node: ast.Call, method: str,
                    held: List[str]) -> None:
        name = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else ""
        receiver = _self_attr(node.func.value) \
            if isinstance(node.func, ast.Attribute) else None

        # manual acquire: record for LOCK001's decline-pattern exemption,
        # LOCK004 edges, and LOCK003's bounded-acquire check
        if attr == "acquire" and receiver in self.locks:
            self.acquires.setdefault(method, set()).add(receiver)
            if held:
                self._note_edge(held, receiver, node)
            if method in self.callback_methods \
                    and not self._acquire_is_bounded(node):
                self._flag(node, LOCK_IN_CALLBACK,
                           f"{self.name}.{method} is registered as a "
                           f"non-blocking callback but acquires "
                           f"self.{receiver} without a bound; use "
                           f"acquire(timeout=...) and decline the pass "
                           f"on contention, or mark "
                           f"`# {PRAGMA_CALLBACK_ALLOW}`",
                           PRAGMA_CALLBACK_ALLOW)
            return

        if not held:
            return

        # LOCK002: blocking shapes while lexically under a lock
        if name in _BLOCKING_NET_CALLS or name in _DEVICE_SYNC_CALLS:
            self._flag(node, LOCK_BLOCKING_HELD,
                       f"{name}() while holding self.{held[-1]} stalls "
                       f"every thread contending for the lock; move the "
                       f"call outside the critical section or mark "
                       f"`# {PRAGMA_BLOCKING}`", PRAGMA_BLOCKING)
        elif attr in _BLOCKING_METHODS and not node.args \
                and not node.keywords:
            if attr == "wait" and receiver in held:
                return          # cond.wait() on the held condition
            self._flag(node, LOCK_BLOCKING_HELD,
                       f".{attr}() with no timeout while holding "
                       f"self.{held[-1]} can park the thread forever "
                       f"inside the critical section; bound the wait or "
                       f"mark `# {PRAGMA_BLOCKING}`", PRAGMA_BLOCKING)
        elif attr in _DEVICE_SYNC_METHODS and not node.args:
            self._flag(node, LOCK_BLOCKING_HELD,
                       f".{attr}() is a device sync while holding "
                       f"self.{held[-1]}; sync first, then take the "
                       f"lock, or mark `# {PRAGMA_BLOCKING}`",
                       PRAGMA_BLOCKING)

    @staticmethod
    def _acquire_is_bounded(node: ast.Call) -> bool:
        if any(kw.arg in ("timeout", None) for kw in node.keywords):
            return True
        for kw in node.keywords:
            if kw.arg == "blocking" \
                    and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return True     # acquire(blocking=False)
        if len(node.args) >= 2:
            return True         # acquire(blocking, timeout)
        if node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value is False:
            return True         # acquire(False): non-blocking probe
        return False

    # -- lock-order edges --------------------------------------------------
    def _note_edge(self, held: List[str], inner_attr: str,
                   site: ast.AST) -> None:
        if not held:
            return
        outer = self.locks.get(held[-1])
        inner = self.locks.get(inner_attr)
        if outer is None or inner is None:
            return
        allowed = any(
            ln in self.module.allowed[PRAGMA_LOCK_ORDER]
            for ln in _stmt_lines(site))
        self.module.edges.append(_Edge(
            outer, inner, self.module.path,
            getattr(site, "lineno", 0), allowed))

    # -- LOCK003: with-blocks inside callbacks --------------------------------
    def check_callbacks(self) -> None:
        for meth in self.callback_methods:
            fn = self.methods.get(meth)
            if fn is None:
                continue
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.With):
                    continue
                for item in sub.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.locks:
                        self._flag(
                            item.context_expr, LOCK_IN_CALLBACK,
                            f"{self.name}.{meth} is registered as a "
                            f"non-blocking callback but takes "
                            f"`with self.{attr}` (unbounded); use "
                            f"acquire(timeout=...) and decline the "
                            f"pass on contention, or mark "
                            f"`# {PRAGMA_CALLBACK_ALLOW}`",
                            PRAGMA_CALLBACK_ALLOW)

    # -- LOCK001 -------------------------------------------------------------
    def check_guarded(self) -> None:
        if not self.locks:
            return
        guards: Dict[str, str] = dict(self.guarded)
        if self.class_guard is not None:
            for w in self.writes:
                if w.attr not in self.locks and w.attr not in guards:
                    guards.setdefault(w.attr, self.class_guard)
        inferred = self._inferred_guards()
        for attr, guard in inferred.items():
            guards.setdefault(attr, guard)
        declared = set(self.guarded) | (
            set(guards) if self.class_guard else set())
        for w in self.writes:
            guard = guards.get(w.attr)
            if guard is None:
                continue
            if self._write_is_allowed(w, guard):
                continue
            how = "declared" if w.attr in declared else "inferred"
            self._flag(w.node, LOCK_UNGUARDED,
                       f"{self.name}.{w.attr} is guarded by "
                       f"self.{guard} ({how}) but written in "
                       f"{w.method}() outside it; take the lock, "
                       f"rename the method `*_locked`, or mark "
                       f"`# {PRAGMA_UNGUARDED}`", PRAGMA_UNGUARDED)

    def _write_is_allowed(self, w: _Write, guard: str) -> bool:
        if w.method in _LIFECYCLE_METHODS:
            return True
        if w.method.endswith("_locked"):
            return True
        if guard in w.held:
            return True
        if guard in self.acquires.get(w.method, ()):
            return True
        allowed = self.module.allowed[PRAGMA_UNGUARDED]
        return any(ln in allowed for ln in _stmt_lines(w.node))

    def _inferred_guards(self) -> Dict[str, str]:
        """Single-lock inference: a class with exactly one lock whose
        attribute is written in >= 2 methods, at least once under the
        lock, is assumed to guard that attribute."""
        if len(self.locks) != 1 or self.class_guard:
            return {}
        guard = next(iter(self.locks))
        by_attr: Dict[str, List[_Write]] = {}
        for w in self.writes:
            if w.attr in self.locks or w.attr in self.guarded:
                continue
            if w.method in _LIFECYCLE_METHODS:
                continue
            by_attr.setdefault(w.attr, []).append(w)
        out: Dict[str, str] = {}
        for attr, ws in by_attr.items():
            methods = {w.method for w in ws}
            if len(methods) < 2:
                continue
            evidence = any(
                guard in w.held or w.method.endswith("_locked")
                or guard in self.acquires.get(w.method, ())
                for w in ws)
            if evidence:
                out[attr] = guard
        return out

    # -- reporting --------------------------------------------------------
    def _flag(self, node: ast.AST, code: str, message: str,
              pragma: str) -> None:
        allowed = self.module.allowed[pragma]
        if any(ln in allowed for ln in _stmt_lines(node)):
            return
        self.module.findings.append(LintFinding(
            self.module.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), code, message))


class _ModuleScan:
    """One parsed module: per-class scans plus the pragma line sets and
    the lock-order edges it contributes to the global graph."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.findings: List[LintFinding] = []
        self.edges: List[_Edge] = []
        self.allowed, self.guarded_lines = _pragma_lines(source)
        self.classes: List[_ClassScan] = []
        self.parse_error: Optional[LintFinding] = None
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            self.parse_error = LintFinding(
                path, e.lineno or 0, e.offset or 0, "SYNTAX",
                f"cannot parse: {e.msg}")
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes.append(_ClassScan(self, node))

    def run(self) -> None:
        if self.parse_error is not None:
            self.findings.append(self.parse_error)
            return
        for cls in self.classes:
            cls.collect_declarations()
            cls.scan_methods()
            cls.check_guarded()
            cls.check_callbacks()


def _check_lock_order(modules: Sequence[_ModuleScan]) -> List[LintFinding]:
    """LOCK004 over the combined edge set: rank inversions, reentrancy
    violations, and directed cycles (Tarjan SCCs)."""
    findings: List[LintFinding] = []
    graph: Dict[str, Set[str]] = {}
    edges: List[_Edge] = []
    for mod in modules:
        for e in mod.edges:
            if e.allowed:
                continue
            edges.append(e)
            o, i = e.outer.node_id(), e.inner.node_id()
            if o != i:
                graph.setdefault(o, set()).add(i)
                graph.setdefault(i, set())

    for e in edges:
        o, i = e.outer.node_id(), e.inner.node_id()
        if o == i:
            if not e.inner.reentrant:
                findings.append(LintFinding(
                    e.path, e.line, 0, LOCK_ORDER,
                    f"'{i}' re-acquired while already held and is not "
                    f"reentrant: self-deadlock; make it reentrant or "
                    f"mark `# {PRAGMA_LOCK_ORDER}`"))
            continue
        if e.outer.rank is not None and e.inner.rank is not None \
                and e.outer.rank >= e.inner.rank:
            findings.append(LintFinding(
                e.path, e.line, 0, LOCK_ORDER,
                f"rank inversion: '{i}' (rank {e.inner.rank}) acquired "
                f"under '{o}' (rank {e.outer.rank}); ranks must be "
                f"strictly increasing — reorder the acquisitions or "
                f"re-rank (see common/locks.py), or mark "
                f"`# {PRAGMA_LOCK_ORDER}`"))

    # Tarjan strongly-connected components; every edge inside an SCC of
    # size > 1 participates in some cycle.
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    scc_of: Dict[str, int] = {}
    counter = [0]
    scc_id = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    for w in comp:
                        scc_of[w] = scc_id[0]
                    scc_id[0] += 1

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    seen: Set[Tuple[str, str]] = set()
    for e in edges:
        o, i = e.outer.node_id(), e.inner.node_id()
        if o == i or (o, i) in seen:
            continue
        if o in scc_of and scc_of.get(i) == scc_of[o]:
            seen.add((o, i))
            members = sorted(n for n, s in scc_of.items()
                             if s == scc_of[o])
            findings.append(LintFinding(
                e.path, e.line, 0, LOCK_ORDER,
                f"lock-order cycle through {{{', '.join(members)}}}: "
                f"'{o}' -> '{i}' closes a loop another thread can "
                f"traverse in the opposite order (deadlock); break the "
                f"cycle or mark `# {PRAGMA_LOCK_ORDER}`"))
    return findings


def check_source(source: str, path: str = "<string>") -> List[LintFinding]:
    """Check one module's source (lock-order graph is local to it)."""
    mod = _ModuleScan(source, path)
    mod.run()
    findings = mod.findings + _check_lock_order([mod])
    return sorted(findings, key=lambda f: (f.line, f.col, f.code))


def check_file(path: str) -> List[LintFinding]:
    text = Path(path).read_text(encoding="utf-8")
    return check_source(text, str(path))


def check_paths(paths: Iterable[str]) -> List[LintFinding]:
    """Check files and directory trees; LOCK004 runs over the COMBINED
    lock-order graph so cross-module cycles are visible."""
    modules: List[_ModuleScan] = []
    for p in paths:
        path = Path(p)
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            mod = _ModuleScan(f.read_text(encoding="utf-8"), str(f))
            mod.run()
            modules.append(mod)
    findings = [f for m in modules for f in m.findings]
    findings.extend(_check_lock_order(modules))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.code))


def check_or_raise(paths: Iterable[str]) -> None:
    """Programmatic gate: raise the same non-retryable PLAN_VALIDATION
    error the plan checker and lint use."""
    findings = check_paths(paths)
    if findings:
        from ..common.errors import PlanValidationError
        head = "; ".join(str(f) for f in findings[:5])
        more = f" (+{len(findings) - 5} more)" if len(findings) > 5 else ""
        raise PlanValidationError(
            f"concurrency check failed: {head}{more}", diagnostics=findings)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m presto_tpu_torch.analysis.concurrency "
              "<path> [path ...]", file=sys.stderr)
        return 2
    findings = check_paths(args)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} concurrency hazard(s)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
