"""RowExpression -> typed postfix program (ExprProgram).

The port's counterpart of presto_tpu/exec/lowering.py.  Instead of
tracing an expression into a device function, `Lowering` COMPILES it
into a small stack program whose every slot is an int64 or float64 value
plus a null bit.  Two interpreters run the same program:

- `ExprProgram.run` (torch, here) evaluates it over whole columns -- the
  streaming Filter/Project path and the scan kernels' plain versions;
- the CUDA scan kernels (kernels/csrc/scan_common.cuh eval_prog)
  interpret it per row inside the fused scan.

A COL instruction may read a column past the scan's: a build column a
join probe gathered, NULL on a LEFT join's misses or where the build
column is NULL, or a semi-join marker, NULL by SQL's three-valued IN.
Both interpreters carry a column's null mask into the program.

So the CPU and the card share one expression semantics, which is the
reference package's: NULL propagates through scalar calls (result null
= OR of argument nulls), AND/OR are Kleene three-valued, decimals are
unscaled int64 with scales taken from the planner's expression types,
and rescaling down rounds half away from zero.

Supported here (the TPC-H Q1/Q6 set plus CAST to double): variable
references, constants, bound parameters, add/subtract/multiply, the six
comparisons, BETWEEN, NOT, CAST, and the AND/OR special forms.  Anything
else raises NotImplementedError naming the missing piece.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.types import (BigintType, BooleanType, CharType, DateType,
                            DecimalType, DoubleType, IntegerType, RealType,
                            Type, VarcharType)
from ..spi.expr import (BoundParameterExpression, CallExpression,
                        ConstantExpression, RowExpression,
                        SpecialFormExpression, VariableReferenceExpression)
from .batch import Batch, Column

# Canonical scalar function names; presto internal operator handles map here.
_CANONICAL = {
    "$operator$add": "add", "$operator$subtract": "subtract",
    "$operator$multiply": "multiply", "$operator$divide": "divide",
    "$operator$modulus": "modulus", "$operator$negation": "negate",
    "$operator$equal": "eq", "$operator$not_equal": "neq",
    "$operator$less_than": "lt", "$operator$less_than_or_equal": "lte",
    "$operator$greater_than": "gt", "$operator$greater_than_or_equal": "gte",
    "$operator$between": "between", "$operator$cast": "cast",
    "presto.default.$operator$add": "add",
    "not": "not",
}


def canonical_name(name: str) -> str:
    n = name.lower()
    return _CANONICAL.get(n, n.split(".")[-1])


def _is_decimal(t):
    return isinstance(t, DecimalType)


def _div_round_half_up(num, den_const: int):
    """Divide by positive constant, rounding half away from zero."""
    return (torch.sign(num) * ((torch.abs(num) + den_const // 2)
                               // den_const)).to(num.dtype)


def _common_super(t1: Type, t2: Type) -> Type:
    from ..common.types import BIGINT, DOUBLE
    if isinstance(t1, (DoubleType, RealType)) \
            or isinstance(t2, (DoubleType, RealType)):
        return DOUBLE
    if _is_decimal(t1) and _is_decimal(t2):
        return DecimalType(38, max(t1.scale, t2.scale))
    if _is_decimal(t1):
        return DecimalType(38, t1.scale)
    if _is_decimal(t2):
        return DecimalType(38, t2.scale)
    return BIGINT


# ---------------------------------------------------------------------------
# constants and bound parameters
# ---------------------------------------------------------------------------

def constant_device_value(value, typ: Type):
    """Python literal -> scalar in the column's logical domain."""
    if value is None:
        return None
    if isinstance(typ, DecimalType):
        from decimal import Decimal
        if isinstance(value, Decimal):
            return int(value.scaleb(typ.scale).to_integral_value())
        if isinstance(value, str):
            return int(Decimal(value).scaleb(typ.scale).to_integral_value())
        return int(value)  # already unscaled
    if isinstance(typ, DateType) and isinstance(value, str):
        return int(np.datetime64(value, "D").astype(np.int64))
    return value


def float_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def param_vector(host_values, types, device) -> torch.Tensor:
    """Host parameter values -> one int64 tensor on `device`; DOUBLE slots
    carry their float64 bit pattern."""
    words = []
    for v, t in zip(host_values, types):
        if isinstance(t, RealType):
            raise NotImplementedError("REAL parameters are not ported yet")
        words.append(float_bits(v) if isinstance(t, DoubleType)
                     else int(v))
    return torch.tensor(words, dtype=torch.int64, device=device)


def expr_has_params(expr: RowExpression) -> bool:
    if isinstance(expr, BoundParameterExpression):
        return True
    if isinstance(expr, (CallExpression, SpecialFormExpression)):
        return any(expr_has_params(a) for a in expr.arguments)
    return False


def torch_dtype(typ: Type):
    """Logical device dtype of a SQL type (presto_tpu's _jnp_dtype)."""
    if isinstance(typ, DoubleType):
        return torch.float64
    if isinstance(typ, RealType):
        raise NotImplementedError("REAL is not ported yet")
    if isinstance(typ, BooleanType):
        return torch.bool
    if isinstance(typ, (IntegerType, DateType)):
        return torch.int32
    return torch.int64


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

# Opcodes: the CUDA interpreter (kernels/csrc/scan_common.cuh) uses the
# same numbers.  Each instruction is (opcode, argument).
OPS = (
    "COL", "CONST_I", "CONST_F", "NULL_I", "NULL_F", "PARAM_I", "PARAM_F",
    "MULC_I", "DIVR_I", "I2F", "DIVC_F", "WRAP32",
    "ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F",
    "LT_I", "LTE_I", "GT_I", "GTE_I", "EQ_I", "NEQ_I",
    "LT_F", "LTE_F", "GT_F", "GTE_F", "EQ_F", "NEQ_F",
    "AND", "OR", "NOT",
)
OP = {name: i for i, name in enumerate(OPS)}
# deepest stack a program may need (it sizes the scan kernel's
# shared-memory stack)
MAX_STACK = 16

_CMP = ("lt", "lte", "gt", "gte", "eq", "neq")
_ARITH = {"add": "ADD", "subtract": "SUB", "multiply": "MUL"}


@dataclass(frozen=True)
class ExprProgram:
    """A compiled expression: postfix (opcode, argument) pairs over the
    named input columns.  `float_result` says whether the final slot is a
    float64; `dtype` is the logical dtype of the result column."""
    ops: Tuple[Tuple[int, int], ...]
    columns: Tuple[str, ...]
    float_result: bool
    dtype: torch.dtype
    depth: int
    uses_params: bool

    def run(self, columns: Dict[str, Column], n: int, params,
            device) -> Column:
        """Evaluate over `n` rows of `columns` (torch interpreter)."""
        if self.uses_params and params is None:
            raise RuntimeError(
                "bound-parameter expression evaluated without a "
                "bound-parameter vector")
        stack: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []

        def full(bits, is_float):
            t = torch.full((n,), bits, dtype=torch.int64, device=device)
            return t.view(torch.float64) if is_float else t

        def orn(a, b):
            if a is None:
                return b
            return a if b is None else a | b

        for op, arg in self.ops:
            name = OPS[op]
            if name == "COL":
                c = columns[self.columns[arg]]
                v = c.values
                if not v.is_floating_point():
                    v = v.to(torch.int64)
                stack.append((v, c.nulls))
            elif name in ("CONST_I", "CONST_F"):
                stack.append((full(arg, name == "CONST_F"), None))
            elif name in ("NULL_I", "NULL_F"):
                stack.append((full(0, name == "NULL_F"),
                              torch.ones(n, dtype=torch.bool,
                                         device=device)))
            elif name in ("PARAM_I", "PARAM_F"):
                p = params[arg].expand(n)
                stack.append((p.view(torch.float64) if name == "PARAM_F"
                              else p, None))
            elif name in ("MULC_I", "DIVR_I", "I2F", "DIVC_F", "WRAP32",
                          "NOT"):
                v, nl = stack.pop()
                if name == "MULC_I":
                    v = v * arg
                elif name == "DIVR_I":
                    v = _div_round_half_up(v, arg)
                elif name == "I2F":
                    v = v.to(torch.float64)
                elif name == "DIVC_F":
                    v = v / struct.unpack("<d", struct.pack("<q", arg))[0]
                elif name == "WRAP32":
                    v = v.to(torch.int32).to(torch.int64)
                else:
                    v = (v == 0).to(torch.int64)
                stack.append((v, nl))
            elif name in ("AND", "OR"):
                (b, bn), (a, an) = stack.pop(), stack.pop()
                av, bv = a != 0, b != 0
                if an is None and bn is None:
                    out = (av & bv) if name == "AND" else (av | bv)
                    stack.append((out.to(torch.int64), None))
                    continue
                an = an if an is not None else torch.zeros_like(av)
                bn = bn if bn is not None else torch.zeros_like(bv)
                if name == "AND":
                    value = (av | an) & (bv | bn)
                    nulls = value & (an | bn)
                    out = value & ~nulls
                else:
                    out = (av & ~an) | (bv & ~bn)
                    nulls = ~out & (an | bn)
                stack.append((out.to(torch.int64), nulls))
            else:
                (b, bn), (a, an) = stack.pop(), stack.pop()
                base = name[:-2]
                if base == "ADD":
                    v = a + b
                elif base == "SUB":
                    v = a - b
                elif base == "MUL":
                    v = a * b
                else:
                    v = {"LT": torch.lt, "LTE": torch.le, "GT": torch.gt,
                         "GTE": torch.ge, "EQ": torch.eq,
                         "NEQ": torch.ne}[base](a, b).to(torch.int64)
                stack.append((v, orn(an, bn)))
        v, nl = stack.pop()
        return Column(v.to(self.dtype), nl)


def _domain_is_float(t: Type) -> bool:
    if isinstance(t, RealType):
        raise NotImplementedError("REAL is not ported yet")
    return isinstance(t, DoubleType)


class _Emitter:
    """Recursive RowExpression -> ExprProgram compiler."""

    def __init__(self):
        self.ops: List[Tuple[int, int]] = []
        self.columns: Dict[str, int] = {}
        self.depth = 0
        self.max_depth = 0
        self.uses_params = False

    def _op(self, name: str, arg: int = 0, delta: int = 0):
        self.ops.append((OP[name], int(arg)))
        self.depth += delta
        self.max_depth = max(self.max_depth, self.depth)

    def emit(self, expr: RowExpression) -> None:
        if isinstance(expr, VariableReferenceExpression):
            _domain_is_float(expr.type)
            idx = self.columns.setdefault(expr.name, len(self.columns))
            self._op("COL", idx, +1)
        elif isinstance(expr, ConstantExpression):
            self._constant(expr)
        elif isinstance(expr, BoundParameterExpression):
            if isinstance(expr.type, (VarcharType, CharType)):
                raise NotImplementedError("varchar parameters in the port")
            self.uses_params = True
            self._op("PARAM_F" if _domain_is_float(expr.type)
                     else "PARAM_I", expr.index, +1)
        elif isinstance(expr, CallExpression):
            self._call(expr)
        elif isinstance(expr, SpecialFormExpression):
            if expr.form not in ("AND", "OR"):
                raise NotImplementedError(
                    f"special form {expr.form} is not ported yet")
            self.emit(expr.arguments[0])
            for a in expr.arguments[1:]:
                self.emit(a)
                self._op(expr.form, 0, -1)
        else:
            raise NotImplementedError(
                f"{type(expr).__name__} is not ported yet")

    def _constant(self, expr: ConstantExpression) -> None:
        if isinstance(expr.type, (VarcharType, CharType)):
            raise NotImplementedError("varchar constants in the port")
        is_f = _domain_is_float(expr.type)
        if expr.value is None:
            self._op("NULL_F" if is_f else "NULL_I", 0, +1)
            return
        v = constant_device_value(expr.value, expr.type)
        if is_f:
            self._op("CONST_F", float_bits(v), +1)
        else:
            self._op("CONST_I", int(v), +1)

    def _convert(self, typ: Type, target: Type) -> None:
        """presto_tpu's _to_common_numeric, applied to the top slot."""
        if _is_decimal(target):
            if _is_decimal(typ):
                self._rescale(typ.scale, target.scale)
            elif target.scale:
                self._op("MULC_I", 10 ** target.scale)
        elif _domain_is_float(target):
            if _is_decimal(typ):
                self._op("I2F")
                self._op("DIVC_F", float_bits(float(10 ** typ.scale)))
            elif not _domain_is_float(typ):
                self._op("I2F")

    def _rescale(self, frm: int, to: int) -> None:
        if to > frm:
            self._op("MULC_I", 10 ** (to - frm))
        elif to < frm:
            self._op("DIVR_I", 10 ** (frm - to))

    def _call(self, expr: CallExpression) -> None:
        name = canonical_name(expr.display_name)
        args = expr.arguments
        if name in _ARITH:
            self._arith(name, expr)
        elif name in _CMP:
            self._compare(name, args[0], args[1])
        elif name == "between":
            self._compare("gte", args[0], args[1])
            self._compare("lte", args[0], args[2])
            self._op("AND", 0, -1)
        elif name == "not":
            self.emit(args[0])
            self._op("NOT")
        elif name == "cast":
            self._cast(args[0], expr.type)
        else:
            raise NotImplementedError(
                f"function {name} is not ported yet")

    def _arith(self, name: str, expr: CallExpression) -> None:
        a, b = expr.arguments
        ta, tb, tr = a.type, b.type, expr.type
        if _domain_is_float(tr):
            for e, t in ((a, ta), (b, tb)):
                self.emit(e)
                self._convert(t, tr)
            self._op(_ARITH[name] + "_F", 0, -1)
            return
        if _domain_is_float(ta) or _domain_is_float(tb):
            raise NotImplementedError("double operand of an exact result")
        if _is_decimal(tr):
            sa = ta.scale if _is_decimal(ta) else 0
            sb = tb.scale if _is_decimal(tb) else 0
            if name == "multiply":
                self.emit(a)
                self.emit(b)
                self._op("MUL_I", 0, -1)
                self._rescale(sa + sb, tr.scale)
                return
            self.emit(a)
            self._rescale(sa, tr.scale)
            self.emit(b)
            self._rescale(sb, tr.scale)
            self._op(_ARITH[name] + "_I", 0, -1)
            return
        self.emit(a)
        self.emit(b)
        self._op(_ARITH[name] + "_I", 0, -1)
        if isinstance(tr, (IntegerType, DateType)):
            self._op("WRAP32")     # int32 arithmetic wraps at 32 bits

    def _compare(self, name: str, a: RowExpression, b: RowExpression) -> None:
        if any(isinstance(e.type, (VarcharType, CharType)) for e in (a, b)):
            raise NotImplementedError("varchar comparison in the port")
        common = _common_super(a.type, b.type)
        for e in (a, b):
            self.emit(e)
            self._convert(e.type, common)
        suffix = "_F" if _domain_is_float(common) else "_I"
        self._op(name.upper() + suffix, 0, -1)

    def _cast(self, arg: RowExpression, to: Type) -> None:
        frm = arg.type
        self.emit(arg)
        if frm.signature == to.signature:
            return
        if isinstance(to, DoubleType):
            self._convert(frm, to)
        elif _is_decimal(to) and not _domain_is_float(frm):
            self._convert(frm, to)
        elif isinstance(to, IntegerType) and not _domain_is_float(frm) \
                and not _is_decimal(frm):
            self._op("WRAP32")
        elif isinstance(to, BigintType) and not _domain_is_float(frm):
            if _is_decimal(frm):
                self._rescale(frm.scale, 0)
        else:
            raise NotImplementedError(f"cast {frm} -> {to} is not ported yet")


def compile_expr(expr: RowExpression) -> ExprProgram:
    em = _Emitter()
    em.emit(expr)
    if em.max_depth > MAX_STACK:
        raise NotImplementedError(
            f"expression needs {em.max_depth} stack slots "
            f"(the kernel interpreter keeps {MAX_STACK})")
    cols = tuple(sorted(em.columns, key=em.columns.get))
    return ExprProgram(tuple(em.ops), cols, _domain_is_float(expr.type),
                       torch_dtype(expr.type), em.max_depth, em.uses_params)


class Lowering:
    """Compiles RowExpressions to ExprPrograms (cached per expression
    object) and evaluates them over Batches."""

    def __init__(self):
        self._programs: Dict[int, Tuple[RowExpression, ExprProgram]] = {}

    def compile(self, expr: RowExpression) -> ExprProgram:
        hit = self._programs.get(id(expr))
        if hit is None or hit[0] is not expr:
            hit = (expr, compile_expr(expr))
            self._programs[id(expr)] = hit
        return hit[1]

    def eval(self, expr: RowExpression, batch: Batch) -> Column:
        if isinstance(expr, VariableReferenceExpression):
            return batch.column(expr.name)
        return self.compile(expr).run(batch.columns, batch.capacity,
                                      batch.params, batch.device)
