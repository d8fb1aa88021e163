"""The scan kernels generated per chain: the direct kernel (#1) and the
span kernel (#3) as CUDA C++.

Replace the Pallas TPU kernels presto_tpu/exec/kernels/scan_kernel.py
build_direct_runner (:580, launched :731) and, in span mode,
presto_tpu/exec/kernels/grouped.py try_grouped_scan_kernel (:213, through
:731 with ops.agg_span_update).  The earlier ports interpreted every
chain step, key and aggregate input per row (an ExprProgram on a stack in
shared memory, its opcodes fetched and dispatched per instruction; the
hash kernel still does).  Here the ScanPlan's programs become
straight-line code, one kernel per chain shape, compiled at first use
with NVRTC (build.py load_generated) for sm_90a.  Both kernels share:

- values and null flags live in registers (i64 per row); each opcode is a
  call of its __device__ function in csrc/scan_common.cuh (op_*, shared
  with the hash kernel's interpreter), so all evaluate one expression
  semantics;
- each column is loaded and decoded once per row, at its first use: a
  column that only a later step, a key or an aggregate reads is fetched
  for the rows still live there, and every later reader shares it;
- bound parameters stay in the launch's device vector and literals travel
  in the launch's argument words, so a new literal reuses the module;
  encodings and dtypes are part of the shape (and so of the source);
- the probe steps (kernel #5) call probe_direct / probe_unique (a unique
  table through its bucket directory) and gather_rows; the stage ring
  (kernel #2, dma="double": the plan's Staging) a generated ring_fill of
  one bulk copy per staged array (ring_copy) on mbarriers, issued by
  thread 0 S - 1 stages ahead, and stage_rows;
- the key code, span's slot rule: code = sum of key value x stride, rows
  off the grid drop;
- a persistent grid: SMs x CTAs per SM stride over the pruned grid's
  8192-row work items in a fixed order.

The direct tail (G <= 64): where G x (folded integer rows + float rows)
fits REG_PARTIALS, each thread keeps its partials in registers across all
its rows (compile-time-unrolled selects on the group code) and the CTA
folds them once at its end; otherwise, per 4 x threads-row pass, the warp
finds each group code's peer lanes once and folds every integer row over
them in one sweep (shared-memory atomics into the CTA's table), and float
rows keep per-thread slots in shared memory.  Float64 sums fold in
(thread, row) order, the CTA's threads in order, then a generated reduce
over the CTAs' partials in a fixed order.

The span tail (G <= 32768), in the tables ScanPlan.layout places: every
integer row folds per row into the CTA's table in shared memory (two
32-bit shared atomics, shared_add64; min / max a 64-bit shared atomic) or,
for a table too large for it, into acc_i by one global atomic a row; a
warp's peer sweep would loop once per distinct code in the warp.  Float
rows never take float atomics: a warp stages its rows per row position
(warp_stage_float: a slot's lanes fold in lane order), then applies them
to its own table in row-position order, or, where only one table per CTA
fits, the CTA applies every warp's pairs in (warp, row position) order
between two barriers.  The reduce is csrc/scan_common.cuh grouped_reduce
over the CTAs' (or warps') partials, the order exec/kernels/grouped.py
reduce_partials models.

In both, floats are bit-identical from launch to launch and between
single and double (the CTA count reserves the smallest ring either way;
the ring's depth fills only the room left).

Bound: the encoded bytes of the scanned columns for the rows live where
each is first read, plus the tables once (device-memory bandwidth, 3.35
TB/s on an H100 SXM).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..lowering import OP, OPS, ExprProgram

# rows a thread carries per pass (csrc/scan_common.cuh RPT)
RPT = 4
# integer and float partials (G x rows) a thread may keep in registers
REG_PARTIALS = 16
REDUCE_THREADS = 256
# fixed argument words (the rest follow: columns, joins, literals)
_W = ("grid", "n_grid", "br", "rows_per_cta", "n_sub", "params", "part_i",
      "part_f", "counts", "acc_i", "acc_f", "n_parts")
_CTYPES = {torch.int8: "int8_t", torch.int16: "int16_t",
           torch.int32: "int32_t", torch.int64: "i64", torch.float64: "i64",
           torch.bool: "uint8_t"}
# plan header words and spec kinds (csrc/scan_common.cuh)
_H_OFF_SPECS, _H_OFF_ROWS = 10, 11
_SPEC_WORDS = 7
_S_COUNT_STAR, _S_COUNT, _S_MIN, _S_MAX = 0, 1, 4, 5
_R_ADD, _R_MIN, _R_MAX = 0, 1, 2


def _hex(v: int) -> str:
    """An int64 as a C literal (two's complement, no overflow)."""
    return f"(i64)0x{v & 0xFFFFFFFFFFFFFFFF:016x}ULL"


# ---------------------------------------------------------------------------
# expressions: one emitter per opcode of lowering.OPS
# ---------------------------------------------------------------------------

class _Expr:
    """Straight-line code of one ExprProgram for row r: statements, and
    the result's value and null-flag expressions (null None: never NULL)."""

    def __init__(self, gen: "_Gen", prog: ExprProgram, prefix: str):
        self.gen, self.prog, self.prefix = gen, prog, prefix
        self.lines: List[str] = []
        self.stack: List[Tuple[str, Optional[str]]] = []
        self.n = 0

    def tmp(self, expr: str, kind: str = "const i64") -> str:
        name = f"{self.prefix}{self.n}"
        self.n += 1
        self.lines.append(f"{kind} {name} = {expr};")
        return name

    def null_tmp(self) -> str:
        name = f"{self.prefix}n{self.n}"
        self.n += 1
        self.lines.append(f"unsigned {name};")
        return name

    def push(self, v: str, n: Optional[str]) -> None:
        self.stack.append((v, n))

    def pop(self) -> Tuple[str, Optional[str]]:
        return self.stack.pop()

    def run(self) -> Tuple[str, Optional[str]]:
        ops = self.prog.ops
        i = 0
        while i < len(ops):
            op, arg = ops[i]
            name = OPS[op]
            emit = EMITTERS.get(name)
            if emit is None:
                raise NotImplementedError(
                    f"the scan kernel generator has no emitter for "
                    f"opcode {name}")
            i += 1 + (emit(self, arg, ops[i + 1:]) or 0)
        (v, n), = self.stack
        return v, n


def _or(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None:
        return b
    return a if b is None else f"({a} | {b})"


def _z(n: Optional[str]) -> str:
    return "0u" if n is None else n


def _e_col(x: _Expr, arg, _rest):
    v, n = x.gen.column(x.prog.columns[arg])
    x.push(v, n)


def _e_const(x: _Expr, arg, _rest):
    x.push(x.gen.literal(arg), None)


def _e_null(x: _Expr, _arg, _rest):
    x.push("(i64)0", "1u")


def _e_param(x: _Expr, arg, _rest):
    x.push(x.gen.param(arg), None)


def _unary(name: str, with_arg: bool):
    def emit(x: _Expr, arg, _rest):
        v, n = x.pop()
        a = f", {_hex(arg)}" if with_arg else ""
        x.push(x.tmp(f"op_{name}({v}{a})"), n)
    return emit


def _binary(name: str):
    def emit(x: _Expr, _arg, _rest):
        (b, bn), (a, an) = x.pop(), x.pop()
        x.push(x.tmp(f"op_{name}({a}, {b})"), _or(an, bn))
    return emit


def _divide(name: str):
    def emit(x: _Expr, arg, _rest):
        (b, bn), (a, an) = x.pop(), x.pop()
        z = x.null_tmp()
        v = x.tmp(f"op_{name}({a}, {b}, {int(arg)}, {z})")
        x.push(v, _or(_or(an, bn), z))
    return emit


def _logic(name: str):
    def emit(x: _Expr, _arg, _rest):
        (b, bn), (a, an) = x.pop(), x.pop()
        n = x.null_tmp()
        v = x.tmp(f"(i64)op_{name}((unsigned)({a} != 0), {_z(an)}, "
                  f"(unsigned)({b} != 0), {_z(bn)}, {n})")
        x.push(v, None if an is None and bn is None else n)
    return emit


def _e_is_null(x: _Expr, _arg, _rest):
    _v, n = x.pop()
    x.push(x.tmp(f"op_IS_NULL({_z(n)})"), None)


def _in(name: str):
    def emit(x: _Expr, arg, rest):
        v, n = x.pop()
        lits = rest[:arg]
        if len(lits) != arg or any(OPS[o] != "LIT" for o, _ in lits):
            raise ValueError(f"{name} wants {arg} LIT instructions")
        hits = " | ".join(f"op_{name}({v}, {x.gen.literal(a)})"
                          for _o, a in lits) or "false"
        x.push(x.tmp(f"(i64)({hits})"), n)
        return arg
    return emit


def _e_lit(_x, _arg, _rest):
    raise ValueError("a LIT instruction outside an IN list")


def _e_if(x: _Expr, _arg, _rest):
    (f, fn), (t, tn), (c, cn) = x.pop(), x.pop(), x.pop()
    n = x.null_tmp()
    v = x.tmp(f"op_IF({c}, {_z(cn)}, {t}, {_z(tn)}, {f}, {_z(fn)}, {n})")
    x.push(v, None if tn is None and fn is None else n)


def _e_coalesce(x: _Expr, _arg, _rest):
    (b, bn), (a, an) = x.pop(), x.pop()
    if an is None:
        x.push(a, None)
        return
    n = x.null_tmp()
    v = x.tmp(f"op_COALESCE({a}, {an}, {b}, {_z(bn)}, {n})")
    x.push(v, None if bn is None else n)


def _nullif(name: str):
    def emit(x: _Expr, _arg, _rest):
        (b, bn), (a, an) = x.pop(), x.pop()
        n = x.null_tmp()
        x.push(x.tmp(f"op_{name}({a}, {_z(an)}, {b}, {_z(bn)}, {n})"), n)
    return emit


EMITTERS: Dict[str, Callable] = {
    "COL": _e_col, "CONST_I": _e_const, "CONST_F": _e_const,
    "NULL_I": _e_null, "NULL_F": _e_null, "PARAM_I": _e_param,
    "PARAM_F": _e_param, "IS_NULL": _e_is_null, "IF": _e_if,
    "COALESCE": _e_coalesce, "LIT": _e_lit,
    "AND": _logic("AND"), "OR": _logic("OR"),
    "IN_I": _in("IN_I"), "IN_F": _in("IN_F"),
    "NULLIF_I": _nullif("NULLIF_I"), "NULLIF_F": _nullif("NULLIF_F"),
}
for _n in ("MULC_I", "DIVR_I", "DIVC_F", "MULC_F"):
    EMITTERS[_n] = _unary(_n, True)
for _n in ("I2F", "WRAP32", "NOT", "NEG_I", "NEG_F", "ABS_I", "ABS_F",
           "YEAR", "MONTH", "DAY", "QUARTER", "RINT_I"):
    EMITTERS[_n] = _unary(_n, False)
for _n in ("ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F", "LT_I",
           "LTE_I", "GT_I", "GTE_I", "EQ_I", "NEQ_I", "LT_F", "LTE_F",
           "GT_F", "GTE_F", "EQ_F", "NEQ_F", "DIV_F", "MOD_F"):
    EMITTERS[_n] = _binary(_n)
for _n in ("DIV_I", "MOD_I", "DIVQ_I", "DIVQS_I"):
    EMITTERS[_n] = _divide(_n)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DirectKernel:
    """A generated direct kernel for one chain shape: its source, the
    recipe of its argument words (fixed words _W, then per column / probe
    / gathered column / literal), launch geometry, layout and ring."""
    source: str
    words: Tuple[tuple, ...]
    threads: int
    ctas_per_sm: int
    smem_bytes: int
    n_fold: int
    registers: bool                  # partials in registers (else warp)
    n_slots: int                     # outputs the reduce writes
    staging: object = None           # the ring (scan_kernel.Staging), None


class _Gen:
    """Emits the kernel of one (plan, column shape, ring)."""

    def __init__(self, plan, shape, staging):
        self.plan, self.shape, self.staging = plan, shape, staging
        self.words: List[tuple] = [(w,) for w in _W]
        self.col_index = {n: i for i, n in enumerate(plan.names)}
        for k, v in enumerate(plan.virtual):
            self.col_index[v.name] = len(plan.names) + k
        self.loaded: Dict[str, Tuple[str, Optional[str]]] = {}
        self.params: Dict[int, str] = {}
        self.body: List[str] = []
        self.ind = 6

    # -- argument words -------------------------------------------------
    def word(self, recipe: tuple) -> str:
        if recipe not in self.words or recipe[0] == "lit":
            self.words.append(recipe)
            return f"a.w[{len(self.words) - 1}]"
        return f"a.w[{self.words.index(recipe)}]"

    def literal(self, value: int) -> str:
        return self.word(("lit", int(value)))

    def param(self, idx: int) -> str:
        if idx not in self.params:
            self.params[idx] = f"p{idx}"
        return f"p{idx}"

    def emit(self, line: str) -> None:
        self.body.append(" " * self.ind + line)

    # -- columns ----------------------------------------------------------
    def column(self, name: str) -> Tuple[str, Optional[str]]:
        """The row-r value (and null flag) of a column, loading it for the
        rows live now on its first use."""
        if name not in self.loaded:
            self._load(name)
        v, n = self.loaded[name]
        return f"{v}[r]", (None if n is None else f"(({n} >> r) & 1u)")

    def _load(self, name: str) -> None:
        c = self.col_index[name]
        var, live = f"c{c}", "live"
        self.emit(f"i64 {var}[RPT];")
        if c < len(self.plan.names):
            kind, dt0, dt1 = self.shape[c]
            t0 = _CTYPES[dt0]
            if kind == "rle":
                self.emit(f"rle_rows<{t0}>({self.word(('col0', c))}, "
                          f"{self.word(('col1', c))}, "
                          f"{self.word(('rle_n', c))}, row0, GT, {live}, "
                          f"{var});")
                self.loaded[name] = (var, None)
                return
            ptr = self.word(("col0", c))
            off = self.staging.offsets[c] if self.staging else -1
            if off >= 0:
                self.emit(f"stage_rows<{t0}>(stage + {off}, {ptr}, pos, "
                          f"dense, k0, GT, {live}, {var});")
            else:
                self.emit(f"load_rows<{t0}>({ptr}, row0, GT, {live}, {var});")
            if kind == "dict":
                self.emit(f"dict_values<{_CTYPES[dt1]}>("
                          f"{self.word(('col1', c))}, {live}, {var});")
            self.loaded[name] = (var, None)
            return
        k = c - len(self.plan.names)
        v = self.plan.virtual[k]
        j = v.join
        if v.kind == "semi":
            self.emit(f"#pragma unroll")
            self.emit(f"for (int r = 0; r < RPT; ++r) {var}[r] = "
                      f"(jhit{j} >> r) & 1u;")
            self.loaded[name] = (var, f"jnul{j}")
            return
        vdt, has_nulls = self.shape[len(self.plan.names) + k]
        sp = self.plan.joins[j].step
        nulls = (f"(const uint8_t*){self.word(('gnull', k))}" if has_nulls
                 else "(const uint8_t*)nullptr")
        self.emit(f"const unsigned cn{c} = gather_rows<{_CTYPES[vdt]}>("
                  f"{self.word(('gval', k))}, {nulls}, jrow{j}, {live}, "
                  f"jhit{j}, {str(bool(sp.is_left)).lower()}, {var});")
        self.loaded[name] = (var, f"cn{c}" if v.nullable else None)

    def preload(self, prog: ExprProgram) -> None:
        for op, arg in prog.ops:
            if op == OP["COL"] and prog.columns[arg] not in self.loaded:
                self._load(prog.columns[arg])

    # -- programs -----------------------------------------------------------
    def rows(self, progs, body: Callable[[List[Tuple[str, Optional[str]]]],
                                         List[str]], prefix: str) -> None:
        """A per-row loop evaluating `progs`; body(results) gives the
        statements that consume their row-r values."""
        for p in progs:
            self.preload(p)
        self.emit("#pragma unroll")
        self.emit("for (int r = 0; r < RPT; ++r) {")
        self.ind += 2
        results = []
        for q, p in enumerate(progs):
            x = _Expr(self, p, f"{prefix}{q}_")
            v, n = x.run()
            for line in x.lines:
                self.emit(line)
            results.append((v, n))
        for line in body(results):
            self.emit(line)
        self.ind -= 2
        self.emit("}")


def _spec_rows(plan):
    """(kind, acc_float, program, vrow, crow, in_float, seen_count) per spec,
    from the plan vector (scan_kernel.build_scan_plan's layout)."""
    w = plan.words
    off = int(w[_H_OFF_SPECS])
    out = []
    for s, spec in enumerate(plan.specs):
        k, acc_f, _off, vrow, crow, in_f, seen = (
            int(v) for v in w[off + _SPEC_WORDS * s:
                              off + _SPEC_WORDS * (s + 1)])
        out.append((k, acc_f, plan.agg_programs.get(spec.output), vrow, crow,
                    in_f, seen))
    return out


def _rows_init(plan):
    """((init, op) per integer row, (init bits, op) per float row)."""
    w = plan.words
    off, n_i, n_f = int(w[_H_OFF_ROWS]), plan.n_i, plan.n_f
    pairs = [(int(w[off + 2 * k]), int(w[off + 2 * k + 1]))
             for k in range(n_i + n_f)]
    return pairs[:n_i], pairs[n_i:]


def column_shape(plan, columns, joins=None) -> Tuple[tuple, ...]:
    """The encodings and dtypes the kernel is specialised to: per scan
    column (kind, dtype of its per-row array, dtype of its second array),
    per virtual column (a gathered column's dtype and whether it carries
    NULL flags; a semi marker's None)."""
    from .scan_kernel import _gathered, scan_shape, step_operands
    shape = list(scan_shape(columns))
    per_step = step_operands(joins) if plan.joins else []
    for v in plan.virtual:
        if v.kind != "gather":
            shape.append(None)
            continue
        vals, nulls = _gathered(plan.joins[v.join].step,
                                per_step[v.join])[v.gather]
        shape.append((vals.dtype, nulls is not None))
    return tuple(shape)


def _emit_chain(g: _Gen, plan, G: int, open_lines: List[str]):
    """The per-pass body both kernels share: the chain's steps (filters,
    probes), then, in the block `open_lines` opens, the key code (span's
    slot rule: code = sum of key value x stride, rows off the grid drop)
    and each aggregate spec's input values and take mask.  Returns (the
    integer folds, the direct kernel's float folds, the float rows as
    (row, take, values, in_float, op))."""
    specs = _spec_rows(plan)
    g.emit("unsigned live = 0;")
    g.emit("#pragma unroll")
    g.emit("for (int r = 0; r < RPT; ++r) "
           "live |= (unsigned)(base + r * GT < hi) << r;")
    g.emit("cnt0 += __popc(live);")
    joins = {jp.step.si: (j, jp) for j, jp in enumerate(plan.joins)}
    for s, prog in enumerate(plan.step_programs):
        if s in joins:
            j, jp = joins[s]
            _emit_probe(g, j, jp)
        elif prog is not None:
            # no braces: a column first loaded here serves later readers
            g.emit(f"unsigned ok{s} = 0;")
            g.rows([prog], lambda res, s=s: [
                f"ok{s} |= (unsigned)({res[0][0]} != 0 && "
                f"!({_z(res[0][1])} & 1u)) << r;"], f"f{s}_")
            g.emit(f"live &= ok{s};")
        g.emit(f"cnt{s + 1} += __popc(live);")

    # -- keys and aggregate inputs -----------------------------------------
    for line in open_lines:
        g.emit(line)
    g.ind += 2
    if plan.key_programs:
        g.emit("i64 code[RPT];")
        strides = plan.strides

        def key_body(res):
            acc = " + ".join(f"{v} * {_hex(int(st))}"
                             for (v, _n), st in zip(res, strides))
            return [f"code[r] = {acc};",
                    f"if (code[r] < 0 || code[r] >= {G}) live &= ~(1u << r);"]
        g.rows(list(plan.key_programs), key_body, "k")
    else:
        g.emit("const i64 code[RPT] = {0};")
    # each spec's input values and take mask
    folds = [("count", 0, "live", None)]        # __seen
    f_folds, f_rows = [], []
    for s, (kind, acc_float, prog, vrow, crow, in_f, seen) in enumerate(specs):
        if kind in (_S_COUNT_STAR, _S_COUNT) and seen:
            continue
        take = "live"
        x = None
        if kind != _S_COUNT_STAR:
            g.emit(f"i64 x{s}[RPT];")
            g.emit(f"unsigned take{s} = live;")

            def body(res, s=s):
                v, n = res[0]
                out = [f"x{s}[r] = {v};"]
                if n is not None:
                    out.append(f"take{s} &= ~(({n} & 1u) << r);")
                return out
            g.rows([prog], body, f"a{s}_")
            take, x = f"take{s}", f"x{s}"
        if kind in (_S_COUNT_STAR, _S_COUNT):
            folds.append(("count", vrow, take, None))
            continue
        op = _R_MIN if kind == _S_MIN else _R_MAX if kind == _S_MAX else _R_ADD
        if acc_float:
            val = f"as_f({x}[r])" if in_f else f"(double){x}[r]"
            f_folds.append((vrow, take, val, op))
            f_rows.append((vrow, take, x, in_f, op))
        else:
            val = f"(i64)as_f({x}[r])" if in_f else f"{x}[r]"
            folds.append(("value", vrow, take, (val, op)))
        if not seen:
            folds.append(("count", crow, take, None))
    return folds, f_folds, f_rows


def generate(plan, shape, staging=None) -> DirectKernel:
    """The direct kernel of `plan` over columns of `shape` (column_shape),
    unstaged or with the stage ring `staging` (ScanPlan.staging).  Its CTAs
    per SM are the plan's (ScanPlan.direct_ctas_per_sm), the same for both.
    Raises NotImplementedError naming an opcode without an emitter, or the
    bytes of a ring that does not fit."""
    from .scan_kernel import check_ring_fits
    T, G = plan.threads, max(plan.G, 1)
    n_i, n_f = plan.n_i, plan.n_f
    fold = [k for k, s in enumerate(plan.src_rows) if s == k]
    pos = {k: q for q, k in enumerate(fold)}
    n_fold = len(fold)
    rows_i, rows_f = _rows_init(plan)
    registers = G * (n_fold + n_f) <= REG_PARTIALS
    g = _Gen(plan, shape, staging)
    ring_bytes = staging.ring_bytes if staging else 0
    if staging:
        check_ring_fits(staging, plan.direct_smem())

    # -- shared memory: [ring][integer table][float slots] ---------------
    smi_off = ring_bytes
    smi_bytes = 8 * n_fold * G
    smf_off = smi_off + -(-smi_bytes // 16) * 16
    smf_bytes = 8 * n_f * G * T
    smem = smf_off + smf_bytes
    ctas = plan.direct_ctas_per_sm()

    folds, f_folds, _f_rows = _emit_chain(
        g, plan, G, ["if (__any_sync(FULL_MASK, live != 0)) {"])
    if registers:
        _emit_reg_folds(g, folds, f_folds, pos, G)
    else:
        _emit_warp_folds(g, folds, pos, G)
        _emit_slot_folds(g, f_folds, G)
    g.ind -= 2
    g.emit("}")

    source = _kernel_source(g, plan, T, ctas, G, n_i, n_f, n_fold, fold, pos,
                            rows_i, rows_f, registers, smi_off, smf_off)
    return DirectKernel(source, tuple(g.words), T, ctas, smem, n_fold,
                        registers, (n_i + n_f) * G, staging)


@dataclasses.dataclass
class SpanKernel:
    """A generated span kernel (#3) for one chain shape: its source, the
    recipe of its argument words, launch geometry and the grouped layout
    it was generated for (ScanPlan.layout)."""
    source: str
    words: Tuple[tuple, ...]
    threads: int
    ctas_per_sm: int
    smem_bytes: int
    layout: object
    staging: object = None           # the ring (scan_kernel.Staging), None


# fixed argument words of the span kernel: the direct kernel's, then the
# float partials' count
_W_SPAN = _W + ("n_fparts",)


def generate_span(plan, shape, staging, layout) -> SpanKernel:
    """The span kernel (#3) of `plan` over columns of `shape`, unstaged or
    with the ring `staging` (as generate), folding into the tables
    `layout` places (ScanPlan.layout(plan.G)): the chain, keys and inputs
    are the direct kernel's code; the tail folds each live row into slot
    code[r].  Raises NotImplementedError naming an opcode without an
    emitter, or the bytes of a ring that does not fit."""
    from .scan_kernel import check_ring_fits
    T, G = plan.threads, plan.G
    warps = T // 32
    n_f = plan.n_f
    fold = [k for k, s in enumerate(plan.src_rows) if s == k]
    pos = {k: q for q, k in enumerate(fold)}
    rows_i, rows_f = _rows_init(plan)
    on = layout.on_chip
    cta_floats = on and n_f > 0 and not layout.warp_floats
    g = _Gen(plan, shape, staging)
    g.words = [(w,) for w in _W_SPAN]
    ring_bytes = staging.ring_bytes if staging else 0
    if staging:
        check_ring_fits(staging, layout.smem_bytes)

    # -- shared memory: [ring][integer table][float tables][staging] -----
    def up(n):
        return -(-n // 16) * 16
    smi_off = ring_bytes
    smf_off = smi_off + up(8 * len(fold) * G * on)
    stg_off = smf_off + up(8 * layout.f_tables * n_f * G * on)
    n_stage = n_f if cta_floats else min(n_f, 1)
    stv_off = stg_off + 8 * RPT * T * n_stage
    smem = stv_off + 8 * RPT * T * n_stage

    open_lines = ["const bool wany = __any_sync(FULL_MASK, live != 0);",
                  "if (wany) {"]
    folds, _f, f_rows = _emit_chain(g, plan, G, open_lines)
    _emit_span_folds(g, folds, f_rows, pos, G, on, cta_floats, warps)
    g.ind -= 2
    g.emit("}")
    if cta_floats:
        _emit_cta_float_apply(g, f_rows, G, warps)
    source = _span_source(g, plan, layout, T, G, fold, pos, rows_i, rows_f,
                          smi_off, smf_off, stg_off, stv_off)
    return SpanKernel(source, tuple(g.words), T, layout.ctas_per_sm, smem,
                      layout, staging)


def _emit_span_folds(g: _Gen, folds, f_rows, pos, G, on: bool,
                     cta_floats: bool, warps: int) -> None:
    """Span's tail for one pass: every integer row folds per row into its
    table -- on chip the CTA's in shared memory (32-bit shared atomics,
    shared_add64), else acc_i by one global atomic a row -- at slot
    code[r]; each float row is staged per row position by its warp
    (warp_stage_float: no float atomics) and applied to the warp's table
    in row-position order, or, for a table per CTA, staged for the CTA's
    ordered apply after the block."""
    g.emit("#pragma unroll")
    g.emit("for (int r = 0; r < RPT; ++r) {")
    g.ind += 2
    for kind, row, take, extra in folds:
        sel = f"(({take}) >> r) & 1u"
        if on:
            slot = f"sm_i[{pos[row] * G} + code[r]]"
        else:
            slot = f"acc_i[{row * G} + code[r]]"
        if kind == "count":
            add = (f"shared_add64(&{slot}, 1)" if on
                   else f"atomicAdd((u64*)&{slot}, 1ULL)")
            g.emit(f"if ({sel}) {add};")
            continue
        val, op = extra
        if op == _R_ADD:
            fn = (f"shared_add64(&{slot}, {val})" if on
                  else f"atomicAdd((u64*)&{slot}, (u64)({val}))")
        else:
            fn = (f"atomicMin(&{slot}, {val})" if op == _R_MIN
                  else f"atomicMax(&{slot}, {val})")
        g.emit(f"if ({sel}) {fn};")
    g.ind -= 2
    g.emit("}")
    for f, (row, take, x, in_f, op) in enumerate(f_rows):
        in_f = "true" if in_f else "false"
        if cta_floats:
            at = f"{f * warps} * RPT * 32 + warp * RPT * 32"
            g.emit(f"warp_stage_float({take}, code, {x}, {op}, {in_f}, "
                   f"stg_c + {at}, stg_v + {at});")
            continue
        g.emit(f"warp_stage_float({take}, code, {x}, {op}, {in_f}, stg_c + "
               f"warp * RPT * 32, stg_v + warp * RPT * 32);")
        # within one row position the staged slots are distinct: the
        # lanes apply them at once, row positions in order
        g.emit("#pragma unroll")
        g.emit("for (int r = 0; r < RPT; ++r) {")
        g.ind += 2
        g.emit("const int at = warp * RPT * 32 + r * 32 + lane;")
        g.emit("const i64 c = stg_c[at];")
        if on:
            g.emit(f"if (c >= 0) pf[{row * G} + c] = fcombine(pf[{row * G} "
                   f"+ c], stg_v[at], {op});")
        else:
            g.emit(f"if (c >= 0) __stcg(pf + {row * G} + c, fcombine(__ldcg("
                   f"pf + {row * G} + c), stg_v[at], {op}));")
        g.emit("__syncwarp();")
        g.ind -= 2
        g.emit("}")


def _emit_cta_float_apply(g: _Gen, f_rows, G, warps: int) -> None:
    """A table per CTA: a warp without live rows stages nothing (slot -1);
    when some warp had rows, the CTA applies every float row's staged
    pairs in (warp, row position) order (apply_staged), between
    barriers."""
    n = len(f_rows)
    g.emit("else {")
    g.emit(f"  for (int k = 0; k < {n} * RPT; ++k) stg_c[(k / RPT * "
           f"{warps} + warp) * RPT * 32 + (k % RPT) * 32 + lane] = -1;")
    g.emit("  __syncwarp();")
    g.emit("}")
    g.emit("if (__syncthreads_or(wany)) {")
    for f, (row, _take, _x, _in_f, op) in enumerate(f_rows):
        at = f"{f * warps} * RPT * 32"
        g.emit(f"  apply_staged(stg_c + {at}, stg_v + {at}, {warps}, {op}, "
               f"sm_f + {row * G});")
    g.emit("  __syncthreads();")
    g.emit("}")


def _span_source(g: _Gen, plan, layout, T, G, fold, pos, rows_i, rows_f,
                 smi_off, smf_off, stg_off, stv_off) -> str:
    n_steps, n_i, n_f = plan.n_steps, plan.n_i, plan.n_f
    n_fold, on = len(fold), layout.on_chip
    W = {w: i for i, w in enumerate(_W_SPAN)}
    out = [
        "// Generated by presto_tpu_torch/exec/kernels/codegen.py: the span",
        "// scan kernel (#3) of one chain shape and its reduce.",
        '#include "scan_common.cuh"',
        f"#define GT {T}",
        f"struct Args {{ i64 w[{len(g.words)}]; }};",
        "",
        "@RING_FILL@",
        f"extern \"C\" __global__ void __launch_bounds__(GT, "
        f"{layout.ctas_per_sm})",
        "scan_span_gen(const Args a) {",
        "  extern __shared__ __align__(16) unsigned char smem[];",
        "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
        "  (void)lane; (void)warp;",
        f"  const i64* grid = (const i64*)a.w[{W['grid']}];",
        f"  const int n_grid = (int)a.w[{W['n_grid']}];",
        f"  const i64 br = a.w[{W['br']}], rows_per_cta = "
        f"a.w[{W['rows_per_cta']}];",
        f"  const int n_sub = (int)a.w[{W['n_sub']}];",
    ]
    if g.params:
        out.append(f"  const i64* params = (const i64*)a.w[{W['params']}];")
        for idx, name in sorted(g.params.items()):
            out.append(f"  const i64 {name} = __ldg(params + {idx});")
    out += [
        f"  i64* sm_i = (i64*)(smem + {smi_off});",
        f"  double* sm_f = (double*)(smem + {smf_off});",
        f"  i64* stg_c = (i64*)(smem + {stg_off});",
        f"  double* stg_v = (double*)(smem + {stv_off});",
        f"  i64* acc_i = (i64*)a.w[{W['acc_i']}];",
        f"  double* part_f = (double*)a.w[{W['part_f']}];",
        "  (void)sm_i; (void)sm_f; (void)stg_c; (void)stg_v; (void)acc_i;",
        "  (void)part_f;",
    ]
    for s in range(n_steps + 1):
        out.append(f"  i64 cnt{s} = 0;")
    # -- the tables, each row from its initial value ---------------------
    if on:
        out.append(f"  for (int k = tid; k < {n_fold * G}; k += GT) {{")
        out.append("    const int q = k / %d;" % G)
        out.append("    i64 v = 0;")
        for q, k in enumerate(fold):
            out.append(f"    if (q == {q}) v = {_hex(rows_i[k][0])};")
        out.append("    sm_i[k] = v;")
        out.append("  }")
    if n_f:
        if on:
            n_tab = layout.f_tables * n_f * G
            out.append(f"  for (int k = tid; k < {n_tab}; k += GT) {{")
            out.append(f"    const int f = k / {G} % {n_f};")
        else:
            out.append("  double* pf = part_f + ((size_t)blockIdx.x * "
                       f"{layout.f_tables} + warp) * {n_f * G};")
            out.append(f"  for (int k = lane; k < {n_f * G}; k += 32) {{")
            out.append(f"    const int f = k / {G};")
        out.append("    i64 v = 0;")
        for f in range(n_f):
            out.append(f"    if (f == {f}) v = {_hex(rows_f[f][0])};")
        out.append("    " + ("sm_f[k] = as_f(v);" if on
                              else "__stcg(pf + k, as_f(v));"))
        out.append("  }")
        if on:
            # this warp's table, or the CTA's (cta floats use sm_f)
            out.append(f"  double* pf = sm_f + warp * {n_f * G};")
            out.append("  (void)pf;")
    out.append("  __syncthreads();")
    out += [
        "  const i64 n_items = (i64)n_grid * n_sub, tile = (i64)RPT * GT;",
    ]
    out += _pass_loop(g)
    # -- epilogue: row counters, then the CTA's tables --------------------
    out.append(f"  u64* counts = (u64*)a.w[{W['counts']}];")
    for s in range(n_steps + 1):
        out += [
            "  {",
            f"    i64 c = cnt{s};",
            "    for (int o = 16; o > 0; o >>= 1) "
            "c += __shfl_down_sync(FULL_MASK, c, o);",
            f"    if ((tid & 31) == 0 && c) atomicAdd(&counts[{s}], (u64)c);",
            "  }",
        ]
    if on:
        out.append(f"  i64* part_i = (i64*)a.w[{W['part_i']}];")
        out.append("  __syncthreads();")
        out.append(f"  for (int k = tid; k < {n_fold * G}; k += GT)")
        out.append(f"    part_i[(size_t)blockIdx.x * {n_fold * G} + k] = "
                   f"sm_i[k];")
        if n_f:
            n_tab = layout.f_tables * n_f * G
            out.append(f"  for (int k = tid; k < {n_tab}; k += GT)")
            out.append(f"    part_f[(size_t)blockIdx.x * {n_tab} + k] = "
                       f"sm_f[k];")
    out.append("}")
    out.append("")
    # -- the reduce: grouped_reduce over the partials, a fixed order -------
    rows = [v for r in rows_i + rows_f for v in r]
    out += [
        f"__constant__ i64 RED_ROWS[{len(rows)}] = "
        f"{{{', '.join(_hex(v) for v in rows)}}};",
        f"__constant__ i64 RED_SRC[{n_i}] = "
        f"{{{', '.join(str(int(v)) for v in plan.src_rows)}}};",
        "extern \"C\" __global__ void __launch_bounds__(32 * REDUCE_LANES)",
        "scan_span_reduce(const Args a) {",
        f"  grouped_reduce(RED_ROWS, RED_SRC, {n_i}, {n_f}, {G}, "
        f"(int)a.w[{W['n_parts']}], (int)a.w[{W['n_fparts']}], "
        f"(const i64*)a.w[{W['part_i']}], (i64*)a.w[{W['acc_i']}], "
        f"(const double*)a.w[{W['part_f']}], (double*)a.w[{W['acc_f']}]);",
        "}",
        "",
    ]
    return _sized_args(out, g)


def _emit_probe(g: _Gen, j: int, jp) -> None:
    """A probe step (kernel #5): its keys, the table lookup, the form."""
    sp = jp.step
    g.emit(f"int jrow{j}[RPT];")
    g.emit(f"unsigned jhit{j} = 0, jnul{j} = 0, knull{j} = 0;")
    w = lambda f: g.word(("join", j, f))           # noqa: E731
    if sp.table == "direct":
        g.emit(f"i64 key{j}[RPT];")
        g.rows([jp.key_programs[0]], lambda res: [
            f"key{j}[r] = {res[0][0]};",
            f"knull{j} |= ({_z(res[0][1])} & 1u) << r;"], f"j{j}_")
        g.emit(f"jhit{j} = probe_direct(key{j}, knull{j}, live, "
               f"(const int32_t*){w('op0')}, (const i64*){w('op1')}, "
               f"{w('size')}, jrow{j});")
    else:
        g.emit(f"u64 h{j}[RPT];")
        g.emit("#pragma unroll")
        g.emit(f"for (int r = 0; r < RPT; ++r) h{j}[r] = 1ULL;")

        def body(res):
            out = []
            for v, n in res:
                out.append(f"h{j}[r] = hash_mix(h{j}[r], {v}, "
                           f"({_z(n)} & 1u) != 0);")
                out.append(f"knull{j} |= ({_z(n)} & 1u) << r;")
            return out
        g.rows(list(jp.key_programs), body, f"j{j}_")
        g.emit(f"jhit{j} = probe_unique(h{j}, knull{j}, live, (const i64*)"
               f"{w('op0')}, (const int32_t*){w('op1')}, {w('size')}, "
               f"(const int32_t*){w('dir')}, (int){w('shift')}, jrow{j});")
    if sp.kind == "semi":
        g.emit(f"jnul{j} = semi_nulls(jhit{j}, knull{j}, (const uint8_t*)"
               f"{w('bhn')});")
    elif not sp.is_left:
        g.emit(f"live &= jhit{j};")


def _emit_reg_folds(g: _Gen, folds, f_folds, pos, G) -> None:
    """Partials in registers: compile-time-unrolled selects on the code."""
    g.emit("#pragma unroll")
    g.emit("for (int r = 0; r < RPT; ++r) {")
    g.ind += 2
    for kind, row, take, extra in folds:
        q = pos[row]
        for grp in range(G):
            sel = f"((({take}) >> r) & 1u)" + (
                f" && code[r] == {grp}" if G > 1 else "")
            acc = f"ri{q}_{grp}"
            if kind == "count":
                g.emit(f"{acc} += ({sel}) ? 1 : 0;")
            else:
                val, op = extra
                g.emit(f"if ({sel}) {acc} = icombine({acc}, {val}, {op});")
    for row, take, val, op in f_folds:
        for grp in range(G):
            sel = f"((({take}) >> r) & 1u)" + (
                f" && code[r] == {grp}" if G > 1 else "")
            acc = f"rf{row}_{grp}"
            g.emit(f"if ({sel}) {acc} = fcombine({acc}, {val}, {op});")
    g.ind -= 2
    g.emit("}")


def _emit_warp_folds(g: _Gen, folds, pos, G) -> None:
    """Per pass: each group code's peer lanes found once, every integer
    row folded over them in one sweep into the CTA's table."""
    g.emit("const int lane = tid & 31;")
    g.emit("unsigned pending = live;")
    g.emit("for (;;) {")
    g.ind += 2
    g.emit("const unsigned lanes = __ballot_sync(FULL_MASK, pending != 0);")
    g.emit("if (!lanes) break;")
    g.emit("const int src = __ffs(lanes) - 1, first = __ffs(pending) - 1;")
    g.emit("i64 mine = 0;")
    g.emit("#pragma unroll")
    g.emit("for (int r = 0; r < RPT; ++r) if (r == first) mine = code[r];")
    g.emit("const i64 c = __shfl_sync(FULL_MASK, mine, src);")
    g.emit("unsigned sel = 0;")
    g.emit("#pragma unroll")
    g.emit("for (int r = 0; r < RPT; ++r) "
           "if (((pending >> r) & 1u) && code[r] == c) sel |= 1u << r;")
    g.emit("pending &= ~sel;")
    for kind, row, take, extra in folds:
        slot = f"sm_i[{pos[row]} * {G} + c]"
        if kind == "count":
            g.emit(f"{{ const unsigned n = __reduce_add_sync(FULL_MASK, "
                   f"__popc(sel & ({take}))); if (lane == src && n) "
                   f"atomicAdd((u64*)&{slot}, (u64)n); }}")
            continue
        val, op = extra
        ident = {_R_ADD: "0", _R_MIN: "I64_MAX", _R_MAX: "I64_MIN"}[op]
        g.emit("{")
        g.ind += 2
        g.emit(f"const unsigned m = sel & ({take});")
        g.emit(f"i64 part = {ident};")
        g.emit("#pragma unroll")
        g.emit(f"for (int r = 0; r < RPT; ++r) if ((m >> r) & 1u) "
               f"part = icombine(part, {val}, {op});")
        g.emit("#pragma unroll")
        g.emit(f"for (int o = 16; o > 0; o >>= 1) part = icombine(part, "
               f"__shfl_xor_sync(FULL_MASK, part, o), {op});")
        atomic = {_R_ADD: f"atomicAdd((u64*)&{slot}, (u64)part)",
                  _R_MIN: f"atomicMin(&{slot}, part)",
                  _R_MAX: f"atomicMax(&{slot}, part)"}[op]
        g.emit(f"if (lane == src) {atomic};")
        g.ind -= 2
        g.emit("}")
    g.ind -= 2
    g.emit("}")


def _emit_slot_folds(g: _Gen, f_folds, G) -> None:
    """Float rows in the thread's own shared-memory slots, in row order."""
    if not f_folds:
        return
    g.emit("#pragma unroll")
    g.emit("for (int r = 0; r < RPT; ++r) {")
    g.ind += 2
    for row, take, val, op in f_folds:
        g.emit(f"if ((({take}) >> r) & 1u) {{ double* s_ = &sm_f[({row} * "
               f"{G} + code[r]) * GT + tid]; *s_ = fcombine(*s_, {val}, "
               f"{op}); }}")
    g.ind -= 2
    g.emit("}")


def _sized_args(out: List[str], g: _Gen) -> str:
    """The source with its argument struct sized to every word, and the
    ring's fill function (_ring_fill) where the kernel stages."""
    lines = []
    for ln in out:
        if ln.startswith("struct Args "):
            ln = f"struct Args {{ i64 w[{len(g.words)}]; }};"
        elif ln == "@RING_FILL@":
            lines += _ring_fill(g)
            continue
        lines.append(ln)
    return "\n".join(lines)


def _ring_fill(g: _Gen) -> List[str]:
    """ring_fill(stage, its full barrier, tile row, rows, array pointers):
    the producer's arming of a stage with the tile's bytes and one bulk
    copy per staged array (csrc/scan_common.cuh ring_copy)."""
    st = g.staging
    if st is None:
        return []
    ptrs = ", ".join(f"u64 arr{c}" for c in st.staged)
    sizes = [(c, f"sizeof({_CTYPES[g.shape[c][1]]})") for c in st.staged]
    tx = " + ".join(f"ring_bytes(arr{c}, {es}, a0, n)" for c, es in sizes)
    out = [f"#define GS {st.stages}", f"#define GP {st.passes}",
           "__device__ __forceinline__ void ring_fill(unsigned char* st, "
           f"u64* full, i64 a0, int n, {ptrs}) {{",
           f"  mbar_expect_tx(full, {tx});"]
    out += [f"  ring_copy(arr{c}, {es}, st + {st.offsets[c]}, a0, n, full);"
            for c, es in sizes]
    return out + ["}", ""]


def _pass_loop(g: _Gen) -> List[str]:
    """The persistent CTA's loop over its work items and their passes, and
    the pass body g.body.  Where the kernel stages, a work item's passes
    run in stages of GP: at a stage's start thread 0 fills the stage the
    previous one read with the stage GS - 1 ahead once every warp released
    it, and every thread waits for the stage; each warp releases it after
    the stage's last pass."""
    st = g.staging
    head = [
        "  for (i64 item = blockIdx.x; item < n_items; item += gridDim.x) {",
        "    i64 bidx, lo, hi;",
        "    item_rows(grid, n_grid, rows_per_cta, n_sub, item, bidx, lo, hi);",
        "    const i64 span = hi - lo;",
        "    const int n_pass = span > 0 ? (int)((span + tile - 1) / tile) : 0;",
    ]
    if st is None:
        return head + [
            "    for (int pass = 0; pass < n_pass; ++pass) {",
            "      const i64 base = lo + (i64)pass * tile + tid;",
            "      const i64 row0 = bidx * br + base;",
        ] + g.body + ["    }", "  }"]
    ptrs = [f"(u64){g.word(('col0', c))}" for c in st.staged]
    fill = ("ring_fill(ring + s * %d, full + s, cur.b * br + cur.lo, "
            "(int)(stage_n < cur.hi - cur.lo ? stage_n : cur.hi - "
            "cur.lo), %s);" % (st.stage_bytes, ", ".join(ptrs)))
    step = ("more = ring_next(cur, stage_n, grid, n_grid, rows_per_cta, "
            "n_sub, n_items);")
    out = [
        "  // the stage ring: GS stages of GP passes, then their full and",
        "  // empty mbarriers",
        "  unsigned char* const ring = smem;",
        f"  u64* const full = (u64*)(smem + {st.stages * st.stage_bytes});",
        "  u64* const empty = full + GS;",
        "  const i64 stage_n = (i64)GP * tile;",
        "  // every staged array 16-byte aligned: an aligned stage is dense",
        f"  const bool arrays16 = (({' | '.join(ptrs)}) & 15) == 0;",
        "  RingCursor cur = {(i64)blockIdx.x, 0, 0, 0};",
        "  bool more = false;",
        "  if (tid == 0) ring_init(full, GS, GT / 32);",
        "  __syncthreads();",
        "  if (tid == 0) {",
        "    more = ring_seek(cur, grid, n_grid, rows_per_cta, n_sub, "
        "n_items);",
        "    for (int s = 0; s < GS - 1 && more; ++s) {",
        f"      {fill}",
        f"      {step}",
        "    }",
        "  }",
        "  int n_used = 0;",
    ] + head + [
        "    for (int pass0 = 0; pass0 < n_pass; pass0 += GP) {",
        "      // the producer: the stage the previous one read, once every",
        "      // warp released it, takes the stage GS - 1 ahead",
        "      if (tid == 0 && more) {",
        "        const int s = (n_used + GS - 1) % GS;",
        "        if (n_used > 0) mbar_wait(empty + s, "
        "(unsigned)((n_used - 1) / GS) & 1u);",
        f"        {fill}",
        f"        {step}",
        "      }",
        "      __syncwarp();",
        "      const int stg = n_used % GS;",
        "      mbar_wait(full + stg, (unsigned)(n_used / GS) & 1u);",
        f"      const unsigned char* stage = ring + stg * {st.stage_bytes};",
        "      const i64 left = span - (i64)pass0 * tile;",
        "      const StagePos pos = {bidx * br + lo + (i64)pass0 * tile,",
        "                            (int)(stage_n < left ? stage_n : left), 0};",
        "      const int dense = stage_dense(arrays16, pos.a0, pos.n);",
        "      const int np = n_pass - pass0 < GP ? n_pass - pass0 : GP;",
        "      for (int sp = 0; sp < np; ++sp) {",
        "        const int pass = pass0 + sp;",
        "        const i64 base = lo + (i64)pass * tile + tid;",
        "        const i64 row0 = bidx * br + base;",
        "        const int k0 = sp * (int)tile + tid;",
    ]
    out += ["  " + ln for ln in g.body]
    out += [
        "      }",
        "      // this warp has read the stage's rows: release it",
        "      __syncwarp();",
        "      if ((tid & 31) == 0) mbar_arrive(empty + stg);",
        "      ++n_used;",
        "    }",
        "  }",
    ]
    return out


def _kernel_source(g: _Gen, plan, T, ctas, G, n_i, n_f, n_fold, fold, pos,
                   rows_i, rows_f, registers, smi_off, smf_off) -> str:
    n_steps = plan.n_steps
    W = {w: i for i, w in enumerate(_W)}
    out = [
        "// Generated by presto_tpu_torch/exec/kernels/codegen.py: the direct",
        "// scan kernel (#1) of one chain shape and its reduce.",
        '#include "scan_common.cuh"',
        f"#define GT {T}",
        f"struct Args {{ i64 w[{len(g.words)}]; }};",
        "",
        "@RING_FILL@",
        f"extern \"C\" __global__ void __launch_bounds__(GT, {ctas})",
        "scan_gen(const Args a) {",
        "  extern __shared__ __align__(16) unsigned char smem[];",
        "  const int tid = threadIdx.x;",
        f"  const i64* grid = (const i64*)a.w[{W['grid']}];",
        f"  const int n_grid = (int)a.w[{W['n_grid']}];",
        f"  const i64 br = a.w[{W['br']}], rows_per_cta = "
        f"a.w[{W['rows_per_cta']}];",
        f"  const int n_sub = (int)a.w[{W['n_sub']}];",
    ]
    if g.params:
        out.append(f"  const i64* params = (const i64*)a.w[{W['params']}];")
        for idx, name in sorted(g.params.items()):
            out.append(f"  const i64 {name} = __ldg(params + {idx});")
    out.append(f"  i64* sm_i = (i64*)(smem + {smi_off});")
    out.append(f"  double* sm_f = (double*)(smem + {smf_off});")
    out.append("  (void)sm_i; (void)sm_f;")
    for s in range(n_steps + 1):
        out.append(f"  i64 cnt{s} = 0;")
    if registers:
        for q, k in enumerate(fold):
            for grp in range(G):
                out.append(f"  i64 ri{q}_{grp} = {_hex(rows_i[k][0])};")
        for f in range(n_f):
            for grp in range(G):
                out.append(f"  double rf{f}_{grp} = as_f("
                           f"{_hex(rows_f[f][0])});")
    else:
        out.append(f"  for (int k = tid; k < {n_fold * G}; k += GT) {{")
        out.append("    const int q = k / %d;" % G)
        out.append("    i64 v = 0;")
        for q, k in enumerate(fold):
            out.append(f"    if (q == {q}) v = {_hex(rows_i[k][0])};")
        out.append("    sm_i[k] = v;")
        out.append("  }")
        for f in range(n_f):
            out.append(f"  for (int s = 0; s < {G}; ++s) sm_f[({f} * {G} + s)"
                       f" * GT + tid] = as_f({_hex(rows_f[f][0])});")
        out.append("  __syncthreads();")
    out += [
        "  const i64 n_items = (i64)n_grid * n_sub, tile = (i64)RPT * GT;",
    ]
    out += _pass_loop(g)
    # -- epilogue: row counters, then the CTA's partials -----------------
    out.append(f"  u64* counts = (u64*)a.w[{W['counts']}];")
    for s in range(n_steps + 1):
        out += [
            "  {",
            f"    i64 c = cnt{s};",
            "    for (int o = 16; o > 0; o >>= 1) "
            "c += __shfl_down_sync(FULL_MASK, c, o);",
            f"    if ((tid & 31) == 0 && c) atomicAdd(&counts[{s}], (u64)c);",
            "  }",
        ]
    out.append(f"  i64* part_i = (i64*)a.w[{W['part_i']}];")
    out.append(f"  double* part_f = (double*)a.w[{W['part_f']}];")
    if registers:
        out.append("  __syncthreads();")
        out.append(f"  for (int k = tid; k < {n_fold * G}; k += GT) {{")
        out.append("    i64 v = 0;")
        for q, k in enumerate(fold):
            out.append(f"    if (k / {G} == {q}) v = {_hex(rows_i[k][0])};")
        out.append("    sm_i[k] = v;")
        out.append("  }")
        out.append("  __syncthreads();")
        for q, k in enumerate(fold):
            op = rows_i[k][1]
            for grp in range(G):
                atomic = {_R_ADD: f"atomicAdd((u64*)&sm_i[{q * G + grp}], "
                                  f"(u64)v)",
                          _R_MIN: f"atomicMin(&sm_i[{q * G + grp}], v)",
                          _R_MAX: f"atomicMax(&sm_i[{q * G + grp}], v)"}[op]
                out += [
                    "  {",
                    f"    i64 v = ri{q}_{grp};",
                    "    for (int o = 16; o > 0; o >>= 1) v = icombine(v, "
                    f"__shfl_xor_sync(FULL_MASK, v, o), {op});",
                    f"    if ((tid & 31) == 0) {atomic};",
                    "  }",
                ]
        for f in range(n_f):
            for grp in range(G):
                out.append(f"  sm_f[({f} * {G} + {grp}) * GT + tid] = "
                           f"rf{f}_{grp};")
    out.append("  __syncthreads();")
    out.append(f"  for (int k = tid; k < {n_fold * G}; k += GT)")
    out.append(f"    part_i[(size_t)blockIdx.x * {n_fold * G} + k] = sm_i[k];")
    if n_f:
        out.append(f"  // float slots combine in thread order")
        out.append(f"  for (int s = tid; s < {n_f * G}; s += GT) {{")
        out.append(f"    const int f = s / {G};")
        out.append("    int op = 0; double acc = 0.0;")
        for f in range(n_f):
            out.append(f"    if (f == {f}) {{ op = {rows_f[f][1]}; "
                       f"acc = as_f({_hex(rows_f[f][0])}); }}")
        out.append("    for (int t = 0; t < GT; ++t) "
                   "acc = fcombine(acc, sm_f[s * GT + t], op);")
        out.append(f"    part_f[(size_t)blockIdx.x * {n_f * G} + s] = acc;")
        out.append("  }")
    out.append("}")
    out.append("")
    # -- the reduce: one CTA per output slot, a fixed order -----------------
    init_i = ", ".join(_hex(rows_i[plan.src_rows[k]][0]) for k in range(n_i))
    op_i = ", ".join(str(rows_i[plan.src_rows[k]][1]) for k in range(n_i))
    pos_i = ", ".join(str(pos[plan.src_rows[k]]) for k in range(n_i))
    out += [
        f"__constant__ i64 RED_INIT_I[{n_i}] = {{{init_i}}};",
        f"__constant__ int RED_OP_I[{n_i}] = {{{op_i}}};",
        f"__constant__ int RED_POS_I[{n_i}] = {{{pos_i}}};",
    ]
    if n_f:
        init_f = ", ".join(_hex(r[0]) for r in rows_f)
        op_f = ", ".join(str(r[1]) for r in rows_f)
        out += [f"__constant__ i64 RED_INIT_F[{n_f}] = {{{init_f}}};",
                f"__constant__ int RED_OP_F[{n_f}] = {{{op_f}}};"]
    out += [
        f"extern \"C\" __global__ void __launch_bounds__({REDUCE_THREADS})",
        "scan_gen_reduce(const Args a) {",
        f"  __shared__ i64 red[{REDUCE_THREADS}];",
        f"  const int n_parts = (int)a.w[{W['n_parts']}];",
        f"  const i64* part_i = (const i64*)a.w[{W['part_i']}];",
        f"  const double* part_f = (const double*)a.w[{W['part_f']}];",
        f"  i64* acc_i = (i64*)a.w[{W['acc_i']}];",
        f"  double* acc_f = (double*)a.w[{W['acc_f']}];",
        "  const int k = blockIdx.x, t = threadIdx.x;",
        f"  if (k < {n_i * G}) {{",
        f"    const int row = k / {G}, grp = k % {G};",
        "    const int op = RED_OP_I[row];",
        "    const i64 at = (i64)RED_POS_I[row] * %d + grp;" % G,
        "    i64 acc = RED_INIT_I[row];",
        f"    for (int b = t; b < n_parts; b += {REDUCE_THREADS})",
        f"      acc = icombine(acc, part_i[(size_t)b * {n_fold * G} + at], op);",
        "    red[t] = acc;",
        "    __syncthreads();",
        f"    for (int s = {REDUCE_THREADS // 2}; s > 0; s >>= 1) {{",
        "      if (t < s) red[t] = icombine(red[t], red[t + s], op);",
        "      __syncthreads();",
        "    }",
        "    if (t == 0) acc_i[k] = red[0];",
    ]
    if n_f:
        out += [
            "  } else {",
            f"    const int s0 = k - {n_i * G}, f = s0 / {G};",
            "    const int op = RED_OP_F[f];",
            "    double acc = as_f(RED_INIT_F[f]);",
            f"    for (int b = t; b < n_parts; b += {REDUCE_THREADS})",
            f"      acc = fcombine(acc, part_f[(size_t)b * {n_f * G} + s0], "
            "op);",
            "    red[t] = as_b(acc);",
            "    __syncthreads();",
            f"    for (int s = {REDUCE_THREADS // 2}; s > 0; s >>= 1) {{",
            "      if (t < s) red[t] = as_b(fcombine(as_f(red[t]), "
            "as_f(red[t + s]), op));",
            "      __syncthreads();",
            "    }",
            "    if (t == 0) acc_f[s0] = as_f(red[0]);",
        ]
    out += ["  }", "}", ""]
    return _sized_args(out, g)
