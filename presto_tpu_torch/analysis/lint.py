"""AST lint for host-device synchronisation hazards in the port's
PyTorch execution code (the torch-idiom copy of
presto_tpu/analysis/lint.py, with the same codes and pragmas).

Operator pipelines should stay on the device: every implicit
device->host transfer (a `.item()`, an `int()` of a device scalar, a
Python `if` on a device boolean) blocks the host on the CUDA stream
exactly where the overlap of host dispatch and device work comes from.
This lint walks Python source with `ast` and flags the hazard shapes:

  SYNC001  explicit host sync: `.item()`, `.cpu()`, `.tolist()` /
           `.numpy()` on a device tensor, `torch.cuda.synchronize()`,
           and `.synchronize()` on an Event or a Stream.  These are
           sometimes *required* (a result's rows, an overflow check)
           but each site must be acknowledged with the allowlist pragma
           so new ones can't creep in silently.
  SYNC002  `int()` / `float()` / `bool()` applied to a device value --
           an implicit transfer hidden inside a cast.
  SYNC003  `np.asarray()` / `np.array()` applied to a device value --
           an implicit transfer hidden inside a conversion.
  SYNC004  Python `if` / `while` branching on a device boolean.
  SYNC005  blocking network I/O (`urllib.request.urlopen` and friends)
           called from a pipeline compute module (`exec/`, `common/`,
           `ops/`, `parallel/`, `connectors/`, `storage/`, `serving/`,
           `telemetry/`); the worker exchange client
           (worker/exchange.py) and the telemetry exporter are the
           sanctioned homes.
  SYNC006  un-metered wall-clock reads (`time.time()` /
           `time.perf_counter()` / ...) in `exec/`; sanctioned metering
           sites carry `# lint: allow-wall-clock`.
  KERNEL001  a call of a kernel's plain version (a function named
           `*_plain`) from a module that does not define it.  The plain
           versions serve the tests, the CPU dispatch inside their own
           wrapper and the measurement harnesses under `benchmarks/`;
           nothing on the main path may call one where a card is
           present.  There is NO pragma escape.
  TELEM001 an unbounded queue (`queue.Queue()` with no / zero maxsize,
           or `queue.SimpleQueue()`) in `telemetry/`.  No pragma escape.
  NET001   a blocking `urllib` request in `worker/` or `telemetry/`
           without an explicit `timeout=` keyword; sites that bound the
           wait elsewhere carry `# lint: allow-no-timeout`.
  MEM001   an unbounded host-side STAGING collection in `exec/` or
           `worker/` (a staging-named attribute initialised to an empty
           list / dict in a class that references no memory-charging
           API); acknowledged with `# lint: allow-uncharged-staging`.

"Device value" is tracked with a deliberately shallow per-scope
dataflow: names assigned from `torch.*` calls (less the ones that
return host metadata or host tensors, `torch.from_numpy` among them) or
from expressions and method calls over such names are device; the
results of `.item()`, `.cpu()`, `.tolist()` and `.numpy()` are host.  A
CPU tensor looks the same as a CUDA one to the lint: it is a tripwire
for review, not a type system, so its precision is tuned to zero
findings on the shipped tree through the pragmas.

Legitimate sync points carry the pragma on any line of the flagged
expression:

    n = int(live.sum())  # lint: allow-host-sync

Run as a module (exits nonzero when any finding survives the pragmas):

    python -m presto_tpu_torch.analysis.lint presto_tpu_torch
"""
from __future__ import annotations

import ast
import io
import sys
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

PRAGMA = "lint: allow-host-sync"
WALL_PRAGMA = "lint: allow-wall-clock"
MEM_PRAGMA = "lint: allow-uncharged-staging"
NET_PRAGMA = "lint: allow-no-timeout"

SYNC_EXPLICIT = "SYNC001"
SYNC_CAST = "SYNC002"
SYNC_ASARRAY = "SYNC003"
SYNC_BRANCH = "SYNC004"
SYNC_NETWORK = "SYNC005"
SYNC_WALLCLOCK = "SYNC006"
KERNEL_PLAIN = "KERNEL001"
TELEM_UNBOUNDED_QUEUE = "TELEM001"
MEM_UNCHARGED_STAGING = "MEM001"
NET_NO_TIMEOUT = "NET001"

ALL_LINT_CODES = (SYNC_EXPLICIT, SYNC_CAST, SYNC_ASARRAY, SYNC_BRANCH,
                  SYNC_NETWORK, SYNC_WALLCLOCK, KERNEL_PLAIN,
                  TELEM_UNBOUNDED_QUEUE, MEM_UNCHARGED_STAGING,
                  NET_NO_TIMEOUT)

# KERNEL001 scope: everywhere but the measurement harnesses, which hold
# each kernel against its plain version as the tests do; a module may
# call the plain versions it defines (a wrapper's CPU dispatch); no
# pragma overrides.
_PLAIN_SUFFIX = "_plain"
_PLAIN_ALLOWLIST = ("presto_tpu_torch/benchmarks/",)

# SYNC005 scope: pipeline compute packages where a blocking HTTP round
# trip would serialise operator execution.  Matching is on path markers,
# not imports: `urllib.parse` / `urllib.error` usage is metadata and
# stays legal everywhere — only the blocking CALLS below are hazards.
_NETWORK_PATH_MARKERS = tuple(
    f"presto_tpu_torch/{p}/" for p in (
        "exec", "common", "ops", "parallel", "connectors", "storage",
        "serving", "telemetry"))
# the worker exchange client is THE sanctioned network home; everything
# else in the marked packages must stay network-free by construction.
# telemetry/export.py is sanctioned too: its OTLP HTTP POSTs run on the
# exporter's background flush thread, never the query path.
_NETWORK_ALLOWLIST = ("presto_tpu_torch/worker/exchange.py",
                      "presto_tpu_torch/telemetry/export.py")
_NETWORK_CALLS = {"urllib.request.urlopen", "urllib.request.urlretrieve",
                  "request.urlopen", "urlopen", "urlopen_internal"}

# NET001 scope: the layers that talk HTTP on purpose.  Every blocking
# urllib request there must pass an explicit `timeout=` keyword — a
# default-timeout socket to a dead peer wedges its thread forever, which
# is exactly the failure mode the fault-tolerant mode exists to survive.
_NET_TIMEOUT_PATH_MARKERS = ("presto_tpu_torch/worker/",
                             "presto_tpu_torch/telemetry/")

# SYNC006 scope: the execution layer proper.  Wall-clock reads there must
# feed a stats surface (RuntimeStats / operator stats / driver walls);
# sanctioned metering sites carry `# lint: allow-wall-clock`.  `_time.*`
# covers the `import time as _time` idiom used by several exec modules.
_WALL_PATH_MARKER = "presto_tpu_torch/exec/"
_WALL_CALLS = {"time.time", "_time.time",
               "time.perf_counter", "_time.perf_counter",
               "time.perf_counter_ns", "_time.perf_counter_ns",
               "time.monotonic", "_time.monotonic"}

# MEM001 scope: the packages whose host-side collections stage QUERY
# data (rows, pages, spill chunks) and therefore grow with input size.
# Granularity is the CLASS: a class that references any charging marker
# is assumed to account for its staging somewhere (the lint is a
# tripwire, not a flow analysis); one that references none must either
# start charging or acknowledge each initializer with the pragma.
_MEM_PATH_MARKERS = ("presto_tpu_torch/exec/", "presto_tpu_torch/worker/")
import re as _re
_MEM_STAGING_NAME = _re.compile(
    r"bucket|page|stag|collect|pending|chunk|spill", _re.IGNORECASE)
_MEM_CHARGE_MARKERS = {"try_reserve", "reserve", "register_revocable",
                       "note_spill", "batch_bytes", "MemoryContext",
                       "MemoryPool", "memory_context"}
_MEM_EMPTY_CTORS = {"list", "dict", "deque", "defaultdict"}

# TELEM001 scope: the telemetry export package.  A backpressure stall in
# a sink must hit a bounded queue (metered drop), never unbounded growth.
_TELEM_PATH_MARKER = "presto_tpu_torch/telemetry/"
_QUEUE_CALLS = {"queue.Queue", "Queue", "queue.LifoQueue", "LifoQueue",
                "queue.PriorityQueue", "PriorityQueue"}
_SIMPLE_QUEUE_CALLS = {"queue.SimpleQueue", "SimpleQueue"}

# Call prefixes whose results live on device.  `torch.cuda.` is NOT in
# the list (streams, events, properties, memory counters are host
# objects); neither are the torch calls in _METADATA_FUNCS.
_DEVICE_PREFIXES = ("torch.",)
_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                  "torch.profiler.", "torch.utils.", "torch.testing.",
                  "torch.autograd.", "torch.library.")
# Calls that block the host on the device (flagged where they occur).
_SYNC_CALLS = {"torch.cuda.synchronize"}
# Methods that copy a tensor to host: their results are host values.
_HOST_METHODS = ("item", "cpu", "tolist", "numpy")
# numpy conversion entry points that force a device->host copy when fed
# a device array.
_NUMPY_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array"}
# Attribute reads on a device tensor that are host metadata, not data,
# and the methods that return such metadata.
_HOST_ATTRS = {"shape", "dtype", "ndim", "size", "nbytes", "device",
               "is_cuda", "layout"}
_METADATA_METHODS = {"numel", "dim", "size", "element_size", "stride",
                     "is_contiguous", "data_ptr", "is_floating_point",
                     "get_device", "nelement"}
# torch functions that return host metadata (Python bools, dtype and
# device objects, iinfo records), host tensors or context managers, not
# device tensors.
_METADATA_FUNCS = {"iinfo", "finfo", "dtype", "device", "result_type",
                   "promote_types", "is_tensor", "is_floating_point",
                   "get_default_dtype", "from_numpy", "no_grad",
                   "inference_mode", "Generator", "manual_seed", "Size",
                   "set_num_threads", "get_num_threads", "is_grad_enabled",
                   "can_cast"}


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.code} {self.message}"


def _dotted(node: ast.AST) -> str:
    """`a.b.c` for a Name/Attribute chain, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _allowed_lines(source: str) -> Dict[str, Set[int]]:
    """Per-pragma sets of line numbers carrying an allowlist comment.

    The two pragmas are deliberately NOT interchangeable: a host-sync
    acknowledgement must not silence a wall-clock finding on the same
    statement (and vice versa), so each code checks only its own set."""
    allowed: Dict[str, Set[int]] = {PRAGMA: set(), WALL_PRAGMA: set(),
                                    MEM_PRAGMA: set(), NET_PRAGMA: set()}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            for pragma, lines in allowed.items():
                if pragma in tok.string:
                    lines.add(tok.start[0])
    except tokenize.TokenizeError:
        pass
    return allowed


class _Linter(ast.NodeVisitor):
    """One pass over a module; `_device` is a stack of per-scope sets of
    names currently bound to device values (function scopes copy their
    enclosing scope so closures over device arrays stay tracked)."""

    def __init__(self, path: str, allowed: Dict[str, Set[int]]):
        self.path = path
        self.allowed = allowed.get(PRAGMA, set())
        self.wall_allowed = allowed.get(WALL_PRAGMA, set())
        self.mem_allowed = allowed.get(MEM_PRAGMA, set())
        self.net_allowed = allowed.get(NET_PRAGMA, set())
        self.findings: List[LintFinding] = []
        self._device: List[Set[str]] = [set()]
        import os
        norm = path.replace(os.sep, "/")
        self._network_scoped = (
            any(m in norm for m in _NETWORK_PATH_MARKERS)
            and not any(norm.endswith(a) for a in _NETWORK_ALLOWLIST))
        self._wall_scoped = _WALL_PATH_MARKER in norm
        self._net_timeout_scoped = any(
            m in norm for m in _NET_TIMEOUT_PATH_MARKERS)
        self._telem_scoped = _TELEM_PATH_MARKER in norm
        self._mem_scoped = any(m in norm for m in _MEM_PATH_MARKERS)
        self._plain_exempt = any(m in norm for m in _PLAIN_ALLOWLIST)
        # the plain versions this module defines (its own CPU dispatch)
        self._defined: Set[str] = set()

    # -- reporting --------------------------------------------------------
    def _flag(self, node: ast.AST, code: str, message: str,
              allowed: Optional[Set[int]] = None) -> None:
        allowed = self.allowed if allowed is None else allowed
        first = getattr(node, "lineno", 0)
        last = getattr(node, "end_lineno", first) or first
        if any(ln in allowed for ln in range(first, last + 1)):
            return
        self.findings.append(LintFinding(
            self.path, first, getattr(node, "col_offset", 0), code, message))

    # -- device-value dataflow --------------------------------------------
    def _scope(self) -> Set[str]:
        return self._device[-1]

    def _is_device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self._scope()
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.startswith(_HOST_PREFIXES):
                return False
            if name.startswith(_DEVICE_PREFIXES):
                return name.rsplit(".", 1)[-1] not in _METADATA_FUNCS
            # method call on a device value (x.sum(), x.to(...))
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _HOST_METHODS:
                    return False  # those syncs are flagged where they occur
                if node.func.attr in _METADATA_METHODS:
                    return False
                return self._is_device(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            return self._is_device(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_device(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_device(node.left) or self._is_device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_device(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_device(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return (self._is_device(node.left)
                    or any(self._is_device(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self._is_device(node.body) or self._is_device(node.orelse)
        return False

    def _bind(self, target: ast.AST, device: bool) -> None:
        if isinstance(target, ast.Name):
            (self._scope().add if device
             else self._scope().discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, device)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, device)

    # -- scopes ------------------------------------------------------------
    def _visit_function(self, node) -> None:
        if node.name.endswith(_PLAIN_SUFFIX):
            self._defined.add(node.name)
        self._device.append(set(self._scope()))
        for arg_default in node.args.defaults + node.args.kw_defaults:
            if arg_default is not None:
                self.visit(arg_default)
        for stmt in node.body:
            self.visit(stmt)
        self._device.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- bindings ----------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        if (isinstance(node.value, ast.Tuple)
                and len(node.targets) == 1
                and isinstance(node.targets[0], (ast.Tuple, ast.List))
                and len(node.targets[0].elts) == len(node.value.elts)):
            for tgt, val in zip(node.targets[0].elts, node.value.elts):
                self._bind(tgt, self._is_device(val))
        else:
            device = self._is_device(node.value)
            for tgt in node.targets:
                self._bind(tgt, device)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, self._is_device(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        if self._is_device(node.value):
            self._bind(node.target, True)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        # iterating a device array yields device rows
        self._bind(node.target, self._is_device(node.iter))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self.visit(node.iter)
        self._bind(node.target, self._is_device(node.iter))
        for cond in node.ifs:
            self.visit(cond)

    # -- memory accounting (MEM001) ----------------------------------------
    def _mem_is_empty_collection(self, value: ast.AST) -> bool:
        if isinstance(value, ast.List) and not value.elts:
            return True
        if isinstance(value, ast.Dict) and not value.keys:
            return True
        if isinstance(value, ast.Call):
            name = _dotted(value.func).rsplit(".", 1)[-1]
            if name not in _MEM_EMPTY_CTORS:
                return False
            if name == "deque":
                # deque(maxlen=N) is bounded: not a staging hazard
                return not any(kw.arg == "maxlen" for kw in value.keywords)
            if name == "defaultdict":
                return True  # defaultdict(list) grows per key: unbounded
            return not value.args  # list(xs)/dict(xs) copy, not staging
        return False

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if self._mem_scoped:
            mentioned: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute):
                    mentioned.add(sub.attr)
                elif isinstance(sub, ast.Name):
                    mentioned.add(sub.id)
            if not mentioned & _MEM_CHARGE_MARKERS:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign):
                        targets, value = sub.targets, sub.value
                    elif (isinstance(sub, ast.AnnAssign)
                          and sub.value is not None):
                        targets, value = [sub.target], sub.value
                    else:
                        continue
                    for tgt in targets:
                        if not (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            continue
                        if not _MEM_STAGING_NAME.search(tgt.attr):
                            continue
                        if self._mem_is_empty_collection(value):
                            self._flag(
                                sub, MEM_UNCHARGED_STAGING,
                                f"class {node.name} stages rows in "
                                f"self.{tgt.attr} but never charges a "
                                "memory context (no try_reserve/"
                                "register_revocable/MemoryContext "
                                "reference); account the bytes or mark "
                                f"`# {MEM_PRAGMA}`",
                                allowed=self.mem_allowed)
        self.generic_visit(node)

    # -- hazards -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name in _SYNC_CALLS:
            self._flag(node, SYNC_EXPLICIT,
                       f"{name}() blocks the host on the device; "
                       f"acknowledge with `# {PRAGMA}` if intended")
        elif isinstance(node.func, ast.Attribute) and not node.args:
            attr = node.func.attr
            if attr in ("item", "cpu"):
                self._flag(node, SYNC_EXPLICIT,
                           f".{attr}() blocks on a device->host copy; "
                           f"acknowledge with `# {PRAGMA}` if intended")
            elif attr in ("tolist", "numpy") \
                    and self._is_device(node.func.value):
                self._flag(node, SYNC_EXPLICIT,
                           f".{attr}() of a device tensor blocks on a "
                           f"device->host copy; acknowledge with "
                           f"`# {PRAGMA}` if intended")
            elif attr == "synchronize":
                self._flag(node, SYNC_EXPLICIT,
                           ".synchronize() stalls the host on the device; "
                           f"acknowledge with `# {PRAGMA}` if intended")
        if (name in ("int", "float", "bool") and len(node.args) == 1
                and not node.keywords and self._is_device(node.args[0])):
            self._flag(node, SYNC_CAST,
                       f"{name}() on a device value forces a blocking "
                       f"transfer; copy it explicitly (with the pragma) or "
                       f"keep the value on the device")
        if (name in _NUMPY_CONVERTERS and node.args
                and self._is_device(node.args[0])):
            self._flag(node, SYNC_ASARRAY,
                       f"{name}() on a device tensor copies to host; stay "
                       f"on the device or copy explicitly with .cpu() and "
                       f"the pragma")
        if self._network_scoped and name in _NETWORK_CALLS:
            self._flag(node, SYNC_NETWORK,
                       f"{name}() is blocking network I/O in a pipeline "
                       f"compute module; route it through the worker "
                       f"exchange client (worker/exchange.py) or "
                       f"acknowledge with `# {PRAGMA}`")
        if self._net_timeout_scoped and name in _NETWORK_CALLS:
            # an explicit timeout= keyword (or a **kwargs splat the
            # caller is trusted to bound) is the compliance signal;
            # positional timeouts don't read as deliberate at review
            bounded = any(kw.arg == "timeout" or kw.arg is None
                          for kw in node.keywords)
            if not bounded:
                self._flag(node, NET_NO_TIMEOUT,
                           f"{name}() without an explicit timeout= can "
                           f"block its thread forever on a dead peer; "
                           f"pass timeout= or mark the site with "
                           f"`# {NET_PRAGMA}`",
                           allowed=self.net_allowed)
        if self._wall_scoped and name in _WALL_CALLS:
            self._flag(node, SYNC_WALLCLOCK,
                       f"{name}() is an un-metered wall-clock read in the "
                       f"execution layer; feed it into RuntimeStats / "
                       f"operator stats, or mark the sanctioned metering "
                       f"site with `# {WALL_PRAGMA}`",
                       allowed=self.wall_allowed)
        if self._telem_scoped:
            self._check_telemetry_queue(node, name)
        leaf = name.rsplit(".", 1)[-1]
        if (leaf.endswith(_PLAIN_SUFFIX) and not self._plain_exempt
                and leaf not in self._defined):
            self._flag(node, KERNEL_PLAIN,
                       f"{name}() is a kernel's plain version called "
                       f"outside its own module; the main path must launch "
                       f"the kernel (call its wrapper; no pragma escape)",
                       allowed=set())
        self.generic_visit(node)

    def _check_telemetry_queue(self, node: ast.Call, name: str) -> None:
        """TELEM001: every queue constructed in presto_tpu/telemetry/
        must carry an explicit nonzero maxsize (queue.Queue treats
        maxsize<=0 as infinite; SimpleQueue is always unbounded)."""
        if name in _SIMPLE_QUEUE_CALLS:
            self._flag(node, TELEM_UNBOUNDED_QUEUE,
                       f"{name}() is always unbounded; the telemetry "
                       f"pipeline must use queue.Queue(maxsize=N) so a "
                       f"stalled sink drops (metered) instead of growing "
                       f"without bound (no pragma escape)",
                       allowed=set())
            return
        if name not in _QUEUE_CALLS:
            return
        def _zeroish(v: ast.AST) -> bool:
            return isinstance(v, ast.Constant) and not v.value
        bounded = bool(node.args) and not _zeroish(node.args[0])
        for kw in node.keywords:
            if kw.arg == "maxsize":
                bounded = not _zeroish(kw.value)
            elif kw.arg is None:
                bounded = True      # **kwargs: assume the caller bounds it
        if not bounded:
            self._flag(node, TELEM_UNBOUNDED_QUEUE,
                       f"{name}() without a positive maxsize is an "
                       f"unbounded buffer in the telemetry pipeline; a "
                       f"stalled sink must drop (metered) at a bound, "
                       f"not grow until OOM (no pragma escape)",
                       allowed=set())

    def visit_If(self, node: ast.If) -> None:
        if self._is_device(node.test):
            self._flag(node.test, SYNC_BRANCH,
                       "Python branch on a device boolean blocks until the "
                       "value is on host; use torch.where, or copy it "
                       "explicitly with the pragma")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._is_device(node.test):
            self._flag(node.test, SYNC_BRANCH,
                       "Python loop condition on a device value blocks every "
                       "iteration; copy it explicitly with the pragma")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> List[LintFinding]:
    """Lint one module's source; returns surviving findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintFinding(path, e.lineno or 0, e.offset or 0,
                            "SYNTAX", f"cannot parse: {e.msg}")]
    linter = _Linter(path, _allowed_lines(source))
    # a module's own plain versions are known before its first call
    linter._defined.update(
        n.name for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name.endswith(_PLAIN_SUFFIX))
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.line, f.col))


def lint_file(path: str) -> List[LintFinding]:
    text = Path(path).read_text(encoding="utf-8")
    return lint_source(text, str(path))


def lint_paths(paths: Iterable[str]) -> List[LintFinding]:
    """Lint files and directory trees (``*.py``, recursively)."""
    findings: List[LintFinding] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for f in sorted(path.rglob("*.py")):
                findings.extend(lint_file(str(f)))
        else:
            findings.extend(lint_file(str(p)))
    return findings


def lint_or_raise(paths: Iterable[str]) -> None:
    """Programmatic gate: raise the same non-retryable PLAN_VALIDATION
    error the plan checker uses, so a build step embedding the lint
    fails through the one typed channel."""
    findings = lint_paths(paths)
    if findings:
        from ..common.errors import PlanValidationError
        head = "; ".join(str(f) for f in findings[:5])
        more = f" (+{len(findings) - 5} more)" if len(findings) > 5 else ""
        raise PlanValidationError(
            f"host-sync lint failed: {head}{more}", diagnostics=findings)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m presto_tpu_torch.analysis.lint <path> "
              "[path ...]",
              file=sys.stderr)
        return 2
    findings = lint_paths(args)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} host-sync hazard(s)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
