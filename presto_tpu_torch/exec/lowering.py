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

REAL values ride the float64 slots (a float32 value is exact there) and
every REAL-typed arithmetic result and conversion is rounded back to
float32 (F2R), which gives the float32 arithmetic's result bit for bit;
a REAL result column is float32.  The planner types arithmetic with a
REAL operand DOUBLE (sql/planner.py _arith_type, as the reference's
planner does), so SQL reaches only the conversions' F2R (a cast to REAL,
a REAL constant or parameter); the F2R after REAL-typed arithmetic is
never planned and serves expression IR typed REAL by hand, which the
reference's Lowering computes in float32: it is kept for parity with
that IR.

Supported here: variable references, constants, bound parameters, add /
subtract / multiply / divide / modulus in the integer, decimal and double
domains (a zero divisor gives NULL outside the double domain), negate,
abs, year / month / day / quarter of a date, the six comparisons,
BETWEEN, NOT, CAST between the numeric types (double to INTEGER / BIGINT
saturating, as XLA converts), and the AND / OR / IS_NULL / IF / COALESCE
/ NULL_IF / IN special forms.  IF and COALESCE are selects over evaluated
slots: every row runs every instruction.

Varchar values are dictionary codes: a slot of the torch interpreter
carries its dictionary (host metadata) beside its values.  The varchar
forms -- comparisons (a per-code truth table against a literal, codes
against codes over one dictionary, a remap across two), LIKE, IN over a
dictionary, substr / length and the dictionary string functions, IF over
two dictionaries (merged) -- are folded on the host into a per-code table
for the slot's dictionary and applied on the device as one gather
(CMP_S, MAP_S, IF_S; the reference's _compare_strings, _like, _in,
_substr, _string_fn with _reencode, _merge_dictionaries).  The tables
are cached per dictionary.  A decimal divide whose numerator scales up
divides by long division (DIVQS_I), exact where the reference's int64
rescale wraps.  The rest of the reference's scalar functions follow
F2I: the double functions (FN_F, FN2_F, FPRED_F), sign, ceiling /
floor / round on decimals and doubles, greatest / least, day_of_week,
day_of_year, ISO week, date_trunc / date_add / date_diff, concat over
dictionaries (CONCAT_S, a fold over their product), the bitwise
functions and shifts, and width_bucket; the regexp, URL and JSON string
functions are MAP_S folds.  The CUDA kernels run the opcodes before
CONST_S only (KERNEL_OPS); a program with a later one declines their
plan build, naming it.

ARRAY values are (capacity, W) element matrices with per-row lengths
(batch.Column.lengths), which no program slot holds: an array function
(array_constructor, subscript, element_at, cardinality, contains,
array_max / array_min, array_position, repeat, sequence) compiles to an
ArrayNode tree evaluated with torch ops over the padded matrix before the
program runs (the reference's Lowering._array_fn), and enters the
program as an ARR slot -- its scalar result, or the array itself when
the whole expression is array-valued.  ARR is past KERNEL_OPS, so a
chain that holds an array form declines the scan kernels.  Anything
else raises NotImplementedError naming the missing piece.
"""
from __future__ import annotations

import functools
import math
import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..common.types import (ArrayType, BigintType, BooleanType, CharType,
                            DateType, DecimalType, DoubleType, IntegerType,
                            RealType, Type, VarcharType)
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


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _wrap32(v):
    return v.to(torch.int32).to(torch.int64)


def civil_from_days(z):
    """Days since the epoch -> (year, month, day): the reference's
    _civil_from_days (Hinnant's algorithm), every division a floor
    division in int64."""
    z = z.to(torch.int64) + 719468
    era = _floor_div(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floor_div(doe - _floor_div(doe, 1460) + _floor_div(doe, 36524)
                     - _floor_div(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floor_div(yoe, 4) - _floor_div(yoe, 100))
    mp = _floor_div(5 * doy + 2, 153)
    d = doy - _floor_div(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _narrow_pair(a, b, arg: int):
    """The operands of DIV_I / MOD_I / DIVQ_I as the reference holds them:
    bit 0 of `arg` says `a` is an int32 (INTEGER / DATE) operand, bit 1
    `b`; jnp keeps each in its own dtype, so its abs wraps at 32 bits, and
    the result takes a's dtype.  Returns (a, b, wrap of a's, wrap of
    b's)."""
    wa = _wrap32 if arg & 1 else (lambda x: x)
    wb = _wrap32 if arg & 2 else (lambda x: x)
    return wa(a), wb(b), wa, wb


def _int_divide(a, b, arg: int, modulus: bool):
    """The reference's integer-domain divide / modulus (_arith): a zero
    divisor divides by 1 and makes the row NULL; the quotient truncates
    toward zero and the remainder takes the dividend's sign."""
    a, b, wa, wb = _narrow_pair(a, b, arg)
    zero = b == 0
    sb = torch.where(zero, torch.ones_like(b), b)
    aa, ab = wa(torch.abs(a)), wb(torch.abs(sb))
    if modulus:
        out = torch.sign(a) * torch.remainder(aa, ab)
    else:
        out = torch.sign(a) * torch.sign(sb) * _floor_div(aa, ab)
    return wa(out), zero


def _decimal_quotient(num, b, arg: int):
    """The reference's decimal divide after the numerator's rescale: round
    half away from zero, NULL on a zero divisor."""
    num, b, wa, wb = _narrow_pair(num, b, arg)
    zero = b == 0
    sb = torch.where(zero, torch.ones_like(b), b)
    ab = wb(torch.abs(sb))
    q = torch.sign(num) * torch.sign(sb) * _floor_div(
        wa(torch.abs(num)) + _floor_div(ab, 2), ab)
    return wa(q), zero


def _scaled_decimal_quotient(num, b, arg: int):
    """DIVQS_I: the decimal divide of an int64 numerator scaled up by
    10**k (arg >> 2) first, rounding half away from zero, NULL on a zero
    divisor -- the reference's rescale + divide, computed by long division
    so that the scaled numerator never leaves int64 (where the reference's
    rescale wraps, e.g. TPC-H Q14's 100.00 * sum / sum at SF10, this is
    the exact quotient)."""
    k = arg >> 2
    _num, b, _wa, wb = _narrow_pair(num, b, arg & 2)
    zero = b == 0
    sb = torch.where(zero, torch.ones_like(b), b)
    ab = wb(torch.abs(sb))
    an = torch.abs(num)
    q, r = _floor_div(an, ab), torch.remainder(an, ab)
    for _ in range(k):
        r = r * 10
        q = q * 10 + _floor_div(r, ab)
        r = torch.remainder(r, ab)
    q = q + (r >= ab - _floor_div(ab, 2)).to(torch.int64)
    return torch.sign(num) * torch.sign(sb) * q, zero


def _float_mod(a, b):
    """jnp.mod: C's fmod, moved to the divisor's sign."""
    m = torch.fmod(a, b)
    return torch.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)


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
            # a REAL slot carries the float32 value, exact in float64
            v = float(np.float32(v))
        words.append(float_bits(v) if isinstance(t, (DoubleType, RealType))
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
        return torch.float32
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
#
# Arguments: COL a column index; CONST_* / LIT a value (float64 bits for
# _F); PARAM_* a parameter index; MULC_* / DIVR_I / DIVC_F a constant;
# DIV_I / MOD_I / DIVQ_I bit 0 (1) for an int32 (INTEGER / DATE) dividend
# and bit 1 (2) for an int32 divisor, which the reference keeps in int32;
# IN_*
# the count k of LIT instructions that follow it, its constant list;
# CONST_S an index into the program's strings, CMP_S one into _CMP,
# MAP_S one into the program's maps (a per-code fold, _fold); F2I the
# integer width (32 or 64); DIVQS_I bit 1 (2) for an int32 divisor and
# the numerator's scale-up k (times 10**k) above bit 2.  NULLIF_X
# compares an integer with a double.
# Stack effects: IF / IF_S pop (cond, then, else); COALESCE, NULLIF_*,
# CMP_S and the other binary ops pop two; IS_NULL, IN_*, MAP_S and the
# unary ops pop one; each pushes one.  DIV_I, MOD_I, DIVQ_I and NULLIF_*
# can make a row NULL, and so can a MAP_S whose fold maps an entry to
# NULL.  After F2I: FN_F / FN2_F / FPRED_F an index into their name
# tuples below; CEILD_I / FLOORD_I / ROUNDD_I a power of ten; ROUND_F the
# float64 bits of 10**digits; DTRUNC / DADD / DDIFF an index into
# DATE_UNITS; CONCAT_S pops its argument's count of slots, WBUCKET four
# (x, lo, hi, n); SHL / SHR / SAR and WBUCKET can make a row NULL.
OPS = (
    "COL", "CONST_I", "CONST_F", "NULL_I", "NULL_F", "PARAM_I", "PARAM_F",
    "MULC_I", "DIVR_I", "I2F", "DIVC_F", "WRAP32",
    "ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F",
    "LT_I", "LTE_I", "GT_I", "GTE_I", "EQ_I", "NEQ_I",
    "LT_F", "LTE_F", "GT_F", "GTE_F", "EQ_F", "NEQ_F",
    "AND", "OR", "NOT",
    "NEG_I", "NEG_F", "ABS_I", "ABS_F", "YEAR", "MONTH", "DAY", "QUARTER",
    "MULC_F", "RINT_I",
    "DIV_I", "MOD_I", "DIVQ_I", "DIV_F", "MOD_F",
    "IS_NULL", "IF", "COALESCE", "NULLIF_I", "NULLIF_F",
    "IN_I", "IN_F", "LIT", "DIVQS_I",
    # -- the torch interpreter's alone (KERNEL_OPS ends before them) ----
    "CONST_S", "NULL_S", "CMP_S", "MAP_S", "IF_S", "NULLIF_X", "F2I",
    # the rest of the scalar function set (the reference's Lowering._call)
    "FN_F", "FN2_F", "FPRED_F", "SIGN_I", "SIGN_F", "CEILD_I", "FLOORD_I",
    "ROUNDD_I", "ROUND_F", "MAX_I", "MIN_I", "MAX_F", "MIN_F",
    "DOW", "DOY", "WEEK", "DTRUNC", "DADD", "DDIFF", "CONCAT_S",
    "BAND", "BOR", "BXOR", "BNOT", "SHL", "SHR", "SAR", "WBUCKET",
    # an array form's value (its ArrayNode, evaluated before the program)
    "ARR",
    # a float64 slot rounded to the nearest float32 (a REAL-typed result)
    "F2R",
)
OP = {name: i for i, name in enumerate(OPS)}
# the opcodes the CUDA scan kernels run (codegen.py, scan_common.cuh)
KERNEL_OPS = frozenset(range(OP["CONST_S"]))
_UNARY = frozenset(("MULC_I", "DIVR_I", "I2F", "DIVC_F", "WRAP32", "NOT",
                    "NEG_I", "NEG_F", "ABS_I", "ABS_F", "YEAR", "MONTH",
                    "DAY", "QUARTER", "MULC_F", "RINT_I", "F2I",
                    "FN_F", "FPRED_F", "SIGN_I", "SIGN_F", "CEILD_I",
                    "FLOORD_I", "ROUNDD_I", "ROUND_F", "DOW", "DOY", "WEEK",
                    "DTRUNC", "BNOT", "F2R"))
_NULLING = frozenset(("DIV_I", "MOD_I", "DIVQ_I", "NULLIF_I", "NULLIF_F",
                      "NULLIF_X", "DIVQS_I", "SHL", "SHR", "SAR"))
# the binary forms of the scalar function set (NULL is the OR of the
# operands' NULLs, and a negative shift count's row)
_BINARY_FNS = frozenset(("FN2_F", "MAX_I", "MIN_I", "MAX_F", "MIN_F",
                         "DADD", "DDIFF", "BAND", "BOR", "BXOR", "SHL",
                         "SHR", "SAR"))
# FN_F's functions of one double (the reference's _DOUBLE_FNS, ceiling,
# floor and truncate), FN2_F's of two, FPRED_F's predicates
FN_F = ("sqrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan", "asin",
        "acos", "atan", "cbrt", "degrees", "radians", "sinh", "cosh", "tanh",
        "ceil", "floor", "trunc")
FN2_F = ("power", "log", "atan2")
FPRED_F = ("is_nan", "is_finite", "is_infinite")
# the array functions (the reference's Lowering._array_fn)
ARRAY_FNS = ("array_constructor", "subscript", "element_at", "cardinality",
             "contains", "array_max", "array_min", "array_position",
             "repeat", "sequence")
# DTRUNC / DADD / DDIFF's units
DATE_UNITS = ("day", "week", "month", "quarter", "year")
# deepest stack a program may need (it sizes the scan kernel's
# shared-memory stack)
MAX_STACK = 16

_CMP = ("lt", "lte", "gt", "gte", "eq", "neq")
_ARITH = {"add": "ADD", "subtract": "SUB", "multiply": "MUL",
          "divide": "DIV", "modulus": "MOD"}
_DATE_PARTS = ("year", "month", "day", "quarter")
_DATE_FNS = ("date_trunc", "date_add", "date_diff", "day_of_week",
             "day_of_year", "week")
_BITWISE = {"bitwise_and": "BAND", "bitwise_or": "BOR",
            "bitwise_xor": "BXOR", "bitwise_left_shift": "SHL",
            "bitwise_right_shift": "SHR",
            "bitwise_arithmetic_shift_right": "SAR"}


def _bits_float(arg: int) -> float:
    return struct.unpack("<d", struct.pack("<q", arg))[0]


@dataclass(frozen=True)
class ExprProgram:
    """A compiled expression: postfix (opcode, argument) pairs over the
    named input columns.  `float_result` says whether the final slot is a
    float64; `dtype` is the logical dtype of the result column (int32
    codes for a varchar result, whose dictionary the run derives)."""
    ops: Tuple[Tuple[int, int], ...]
    columns: Tuple[str, ...]
    float_result: bool
    dtype: torch.dtype
    depth: int
    uses_params: bool
    # whether a row's result can be NULL (the reference's static rule: a
    # NULL-able column or constant, a divide / modulus outside the double
    # domain, NULL_IF; IS_NULL, COALESCE and IF narrow it)
    nullable: bool = False
    # CONST_S's string literals and MAP_S's fold specs (_fold)
    strings: Tuple[str, ...] = ()
    maps: Tuple[tuple, ...] = ()
    # ARR's array forms (ArrayNode trees)
    arrays: Tuple["ArrayNode", ...] = ()

    def run(self, columns: Dict[str, Column], n: int, params,
            device) -> Column:
        """Evaluate over `n` rows of `columns` (torch interpreter).  A
        slot is (values, nulls, dictionary)."""
        if self.uses_params and params is None:
            raise RuntimeError(
                "bound-parameter expression evaluated without a "
                "bound-parameter vector")
        arrays = [a.eval(columns, n, params, device) for a in self.arrays]
        if len(self.ops) == 1 and arrays and arrays[0].lengths is not None:
            # the expression is an array: its matrix is the result
            return arrays[0]
        stack: List[tuple] = []

        def full(bits, is_float):
            t = torch.full((n,), bits, dtype=torch.int64, device=device)
            return t.view(torch.float64) if is_float else t

        def orn(a, b):
            if a is None:
                return b
            return a if b is None else a | b

        i = 0
        while i < len(self.ops):
            op, arg = self.ops[i]
            i += 1
            name = OPS[op]
            if name == "COL":
                c = columns[self.columns[arg]]
                if c.lazy is not None:
                    # row ids, not values: the string forms over a lazy
                    # column are hoisted to the host by the compiler
                    raise NotImplementedError(
                        f"expression over the late-materialized column "
                        f"{self.columns[arg]} ({c.lazy[1]}.{c.lazy[2]})")
                v = c.values
                if not v.is_floating_point():
                    v = v.to(torch.int64)
                elif v.dtype == torch.float32:
                    v = v.to(torch.float64)     # a REAL column, exact
                stack.append((v, c.nulls, c.dictionary))
            elif name == "ARR":
                c = arrays[arg]
                if c.lengths is not None:
                    raise NotImplementedError(
                        "an array value inside a scalar expression")
                v = c.values
                if not v.is_floating_point():
                    v = v.to(torch.int64)
                stack.append((v, c.nulls, None))
            elif name in ("CONST_I", "CONST_F"):
                stack.append((full(arg, name == "CONST_F"), None, None))
            elif name in ("NULL_I", "NULL_F", "NULL_S"):
                stack.append((full(0, name == "NULL_F"),
                              torch.ones(n, dtype=torch.bool,
                                         device=device),
                              ("",) if name == "NULL_S" else None))
            elif name == "CONST_S":
                stack.append((full(0, False), None,
                              _literal_dictionary(self.strings[arg])))
            elif name in ("PARAM_I", "PARAM_F"):
                p = params[arg].expand(n)
                stack.append((p.view(torch.float64) if name == "PARAM_F"
                              else p, None, None))
            elif name in _UNARY:
                v, nl, _d = stack.pop()
                stack.append((_unary(name, arg, v), nl, None))
            elif name == "MAP_S":
                v, nl, d = stack.pop()
                stack.append(_apply_fold(self.maps[arg], v, nl, d))
            elif name == "CONCAT_S":
                parts = stack[-arg:]
                del stack[-arg:]
                stack.append(_concat(parts, n, device))
            elif name == "WBUCKET":
                parts = stack[-4:]
                del stack[-4:]
                v, made = _width_bucket(*(p[0] for p in parts))
                nulls = made
                for p in parts:
                    nulls = orn(nulls, p[1])
                stack.append((v, nulls, None))
            elif name in _BINARY_FNS:
                (b, bn, _bd), (a, an, _ad) = stack.pop(), stack.pop()
                v, made = _binary_fn(name, arg, a, b)
                # date_add's NULLs are its date's alone (the reference
                # reads the count's values only)
                nulls = bn if name == "DADD" else orn(an, bn)
                stack.append((v, orn(nulls, made), None))
            elif name == "CMP_S":
                (b, bn, bd), (a, an, ad) = stack.pop(), stack.pop()
                stack.append((_compare_codes(_CMP[arg], a, ad, b, bd),
                              orn(an, bn), None))
            elif name == "IS_NULL":
                _v, nl, _d = stack.pop()
                stack.append((torch.zeros(n, dtype=torch.int64, device=device)
                              if nl is None else nl.to(torch.int64), None,
                              None))
            elif name in ("IN_I", "IN_F"):
                v, nl, _d = stack.pop()
                hit = torch.zeros(n, dtype=torch.bool, device=device)
                for _lit, bits in self.ops[i:i + arg]:
                    hit = hit | (v == (_bits_float(bits) if name == "IN_F"
                                       else bits))
                i += arg
                stack.append((hit.to(torch.int64), nl, None))
            elif name in ("IF", "IF_S"):
                (f, fn, fd), (t, tn, td), (c, cn, _cd) = (
                    stack.pop(), stack.pop(), stack.pop())
                if name == "IF_S":
                    (t, td), (f, fd) = _merge_dictionaries(t, td, f, fd)
                pred = c != 0
                if cn is not None:
                    pred = pred & ~cn
                nulls = None
                if tn is not None or fn is not None:
                    nulls = torch.where(pred, _mask(tn, n, device),
                                        _mask(fn, n, device))
                stack.append((torch.where(pred, t, f), nulls, td))
            elif name == "COALESCE":
                (b, bn, _bd), (a, an, _ad) = stack.pop(), stack.pop()
                if an is None:
                    stack.append((a, None, None))
                else:
                    stack.append((torch.where(an, b, a),
                                  None if bn is None else an & bn, None))
            elif name in ("AND", "OR"):
                (b, bn, _bd), (a, an, _ad) = stack.pop(), stack.pop()
                av, bv = a != 0, b != 0
                if an is None and bn is None:
                    out = (av & bv) if name == "AND" else (av | bv)
                    stack.append((out.to(torch.int64), None, None))
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
                stack.append((out.to(torch.int64), nulls, None))
            else:
                (b, bn, _bd), (a, an, _ad) = stack.pop(), stack.pop()
                base = name[:-2]
                made = None           # rows the op itself makes NULL
                if base == "ADD":
                    v = a + b
                elif base == "SUB":
                    v = a - b
                elif base == "MUL":
                    v = a * b
                elif name in ("DIV_I", "MOD_I"):
                    v, made = _int_divide(a, b, arg, name == "MOD_I")
                elif name == "DIVQ_I":
                    v, made = _decimal_quotient(a, b, arg)
                elif name == "DIVQS_I":
                    v, made = _scaled_decimal_quotient(a, b, arg)
                elif name == "DIV_F":
                    v = a / b
                elif name == "MOD_F":
                    v = _float_mod(a, b)
                elif base == "NULLIF":
                    # NULLIF_X: an integer against a double, compared as
                    # jnp promotes them (float64)
                    eq = (a.to(torch.float64) == b.to(torch.float64)
                          if name == "NULLIF_X" else a == b)
                    v = a
                    made = eq & ~_mask(an, n, device) \
                        & ~_mask(bn, n, device)
                    bn = None
                else:
                    v = {"LT": torch.lt, "LTE": torch.le, "GT": torch.gt,
                         "GTE": torch.ge, "EQ": torch.eq,
                         "NEQ": torch.ne}[base](a, b).to(torch.int64)
                stack.append((v, orn(orn(an, bn), made), None))
        v, nl, d = stack.pop()
        return Column(v.to(self.dtype), nl, d)


# ---------------------------------------------------------------------------
# dictionary folds (host) applied as device gathers
# ---------------------------------------------------------------------------

def like_matcher(pattern: str, escape: Optional[str] = None):
    """SQL LIKE pattern -> predicate: only % and _ are wildcards, every
    other character (regex metacharacters included) is literal."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    rx = re.compile("".join(out), re.DOTALL)
    return lambda s: rx.fullmatch(s) is not None


def _lpad(s, n, fill=" "):
    n, fill = int(n), str(fill)
    if len(s) >= n:
        return s[:n]
    pad = n - len(s)
    return (fill * (pad // len(fill) + 1))[:pad] + s


def _rpad(s, n, fill=" "):
    n, fill = int(n), str(fill)
    if len(s) >= n:
        return s[:n]
    pad = n - len(s)
    return s + (fill * (pad // len(fill) + 1))[:pad]


def _split_part(s, delim, index):
    parts = s.split(str(delim))
    i = int(index)
    if i < 1 or i > len(parts):
        return None
    return parts[i - 1]


def _substr(s, start, length=None):
    i = start - 1 if start > 0 else len(s) + start
    return s[i:i + length] if length is not None else s[i:]


# regexp / URL / JSON functions over dictionary entries or host strings
# (the reference's helpers: RegexpFunctions with re2j approximated by
# `re`, UrlFunctions, JsonFunctions); None is SQL NULL

def _regexp_like(s, pattern):
    return re.compile(str(pattern)).search(s) is not None


def _regexp_extract(s, pattern, group=0):
    m = re.compile(str(pattern)).search(s)
    if m is None:
        return None
    try:
        return m.group(int(group))
    except IndexError:
        return None


def _regexp_replace(s, pattern, repl=""):
    # Presto's replacement references are $N / ${name}; python's \N
    py = re.sub(r"\$(\d+)", r"\\\1", str(repl))
    py = re.sub(r"\$\{(\w+)\}", r"\\g<\1>", py)
    return re.compile(str(pattern)).sub(py, s)


def _url_parts(s):
    from urllib.parse import urlparse
    return urlparse(s)


def _url_port(s):
    try:
        return _url_parts(s).port       # None when absent
    except ValueError:                  # a malformed port is NULL
        return None


def _json_extract_scalar(s, path):
    """The reference's subset of the JsonExtract path language:
    $.a.b[0].c -- object fields and array subscripts."""
    import json as _json
    try:
        v = _json.loads(s)
    except (ValueError, TypeError):
        return None
    p = str(path)
    if not p.startswith("$"):
        return None
    for tok in re.findall(r"\.([A-Za-z_][\w]*)|\[(\d+)\]|\[\"([^\"]+)\"\]",
                          p[1:]):
        field, idx, qfield = tok
        key = field or qfield
        if key:
            if not isinstance(v, dict) or key not in v:
                return None
            v = v[key]
        else:
            if not isinstance(v, list) or int(idx) >= len(v):
                return None
            v = v[int(idx)]
    if isinstance(v, (dict, list)) or v is None:
        return None          # scalars only
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


# string -> string functions over dictionary entries (None = SQL NULL)
STRING_TO_STRING = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "reverse": lambda s: s[::-1],
    "replace": lambda s, find, repl="": s.replace(str(find), str(repl)),
    "lpad": _lpad,
    "rpad": _rpad,
    "split_part": _split_part,
    "regexp_extract": _regexp_extract,
    "regexp_replace": _regexp_replace,
    "url_extract_protocol": lambda s: _url_parts(s).scheme or None,
    "url_extract_host": lambda s: _url_parts(s).hostname or None,
    "url_extract_path": lambda s: _url_parts(s).path,
    "url_extract_query": lambda s: _url_parts(s).query or None,
    "url_extract_fragment": lambda s: _url_parts(s).fragment or None,
    "json_extract_scalar": _json_extract_scalar,
}
# string -> value functions: name -> (fn(entry, *args), numpy dtype)
STRING_TO_VALUE = {
    "length": (len, np.int64),
    "strpos": (lambda s, sub: s.find(str(sub)) + 1, np.int64),
    "starts_with": (lambda s, p: s.startswith(str(p)), bool),
    "ends_with": (lambda s, p: s.endswith(str(p)), bool),
    "codepoint": (lambda s: ord(s[0]) if s else None, np.int64),
    "regexp_like": (_regexp_like, bool),
    "url_extract_port": (_url_port, np.int64),
}

# host folds cached per (tag, dictionaries' ids, device): (dicts, result)
_FOLDS: Dict[tuple, tuple] = {}


@functools.lru_cache(maxsize=None)
def _literal_dictionary(s: str) -> tuple:
    """A string literal's one-entry dictionary: one object per literal,
    so a fold over it is built and cached once, not once per chunk."""
    return (s,)


def _fold(spec: tuple, dictionary, device):
    """A MAP_S spec over one dictionary -> (per-code value table, output
    dictionary or None, per-code NULL table or None), as device tensors,
    folded on the host once per dictionary.  Specs: ("like", pattern),
    ("in", values), ("substr", start, length), ("str", name, args) and
    ("val", name, args)."""
    if dictionary is None:
        raise NotImplementedError(f"{spec[0]} on non-dictionary varchar")
    return _memo(("fold", spec), (dictionary,), device,
                 lambda: _build_fold(spec, dictionary, device))


def _build_fold(spec: tuple, dictionary, device):
    kind = spec[0]
    out_dict = None
    if kind == "like":
        match = like_matcher(spec[1])
        raw = [match(s) for s in dictionary]
    elif kind == "in":
        raw = [s in spec[1] for s in dictionary]
    elif kind in ("substr", "str"):
        mapped = ([_substr(s, *spec[1:]) for s in dictionary]
                  if kind == "substr" else
                  [STRING_TO_STRING[spec[1]](s, *spec[2])
                   for s in dictionary])
        # re-encode: dedup and sort, so codes stay rank codes
        out_dict = tuple(sorted({s for s in mapped if s is not None})) \
            or ("",)
        index = {s: i for i, s in enumerate(out_dict)}
        raw = [0 if s is None else index[s] for s in mapped]
        nulls = [s is None for s in mapped]
    else:
        fn, _dt = STRING_TO_VALUE[spec[1]]
        vals = [fn(s, *spec[2]) for s in dictionary]
        raw = [0 if v is None else v for v in vals]
        nulls = [v is None for v in vals]
    table = torch.tensor(np.asarray(raw, dtype=np.int64).reshape(-1),
                         dtype=torch.int64, device=device)
    null_tab = (torch.tensor(nulls, dtype=torch.bool, device=device)
                if kind in ("substr", "str", "val") and any(nulls)
                else None)
    return table, out_dict, null_tab


def _memo(tag: tuple, dicts: tuple, device, build):
    """build() for these dictionaries, computed on the host once and
    cached (keyed by the dictionaries' identities, so a chunk's lookup
    hashes no dictionary)."""
    key = (tag, tuple(id(d) for d in dicts), str(device))
    hit = _FOLDS.get(key)
    if hit is not None and all(x is d for x, d in zip(hit[0], dicts)):
        return hit[1]
    out = build()
    _FOLDS[key] = (dicts, out)
    return out


def _cached_table(tag: tuple, dicts: tuple, device, build):
    """A per-code int64 table built on the host, cached on the device."""
    return _memo(tag, dicts, device, lambda: torch.tensor(
        build(), dtype=torch.int64, device=device))


def _apply_fold(spec: tuple, v, nulls, dictionary):
    table, out_dict, null_tab = _fold(spec, dictionary, v.device)
    out = table[v]
    if null_tab is not None:
        made = null_tab[v]
        nulls = made if nulls is None else nulls | made
    return out, nulls, out_dict


_PYOPS = {"eq": lambda a, b: a == b, "neq": lambda a, b: a != b,
          "lt": lambda a, b: a < b, "lte": lambda a, b: a <= b,
          "gt": lambda a, b: a > b, "gte": lambda a, b: a >= b}
_TORCH_CMP = {"eq": torch.eq, "neq": torch.ne, "lt": torch.lt,
              "lte": torch.le, "gt": torch.gt, "gte": torch.ge}
_FLIP = {"eq": "eq", "neq": "neq", "lt": "gt", "lte": "gte", "gt": "lt",
         "gte": "lte"}


def _compare_codes(name: str, a, ad, b, bd):
    """The reference's _compare_strings over codes: a per-code truth table
    against a one-entry (literal) dictionary, codes compared directly over
    one dictionary (sorted, so codes are rank codes), or b's codes mapped
    into a's dictionary (equality only)."""
    if ad is None or bd is None:
        raise NotImplementedError("string comparison requires dictionaries")
    if len(bd) == 1:
        lit, op = bd[0], _PYOPS[name]
        return _cached_table(("cmp", name), (ad, bd), a.device, lambda: [
            int(op(s, lit)) for s in ad])[a]
    if len(ad) == 1:
        return _compare_codes(_FLIP[name], b, bd, a, ad)
    if ad == bd:
        return _TORCH_CMP[name](a, b).to(torch.int64)
    if name not in ("eq", "neq"):
        raise NotImplementedError("ordering across distinct dictionaries")
    def remap():
        index = {s: i for i, s in enumerate(ad)}
        return [index.get(s, -1) for s in bd]
    bv = _cached_table(("remap",), (ad, bd), a.device, remap)[b]
    if name == "eq":
        return ((a == bv) & (bv >= 0)).to(torch.int64)
    return ((a != bv) | (bv < 0)).to(torch.int64)


def _merge_dictionaries(a, ad, b, bd):
    """Two code slots onto one union dictionary (the reference's
    _merge_dictionaries): ((a, dict), (b, dict))."""
    if ad is None or bd is None or ad == bd:
        return (a, ad), (b, bd)
    def build():
        union = tuple(sorted(set(ad) | set(bd)))
        index = {s: i for i, s in enumerate(union)}
        return union, *(torch.tensor([index[s] for s in d],
                                     dtype=torch.int64, device=a.device)
                        for d in (ad, bd))
    union, ta, tb = _memo(("merge",), (ad, bd), a.device, build)
    return (ta[a], union), (tb[b], union)


def _mask(nulls, n, device):
    return (torch.zeros(n, dtype=torch.bool, device=device)
            if nulls is None else nulls)


def _unary(name: str, arg: int, v):
    if name == "MULC_I":
        return v * arg
    if name == "DIVR_I":
        return _div_round_half_up(v, arg)
    if name == "I2F":
        return v.to(torch.float64)
    if name == "F2R":
        return v.to(torch.float32).to(torch.float64)
    if name == "DIVC_F":
        return v / _bits_float(arg)
    if name == "MULC_F":
        return v * _bits_float(arg)
    if name == "RINT_I":
        return torch.round(v).to(torch.int64)      # half to even
    if name == "F2I":
        return _saturating_int(v, arg)
    if name == "WRAP32":
        return _wrap32(v)
    if name == "NOT":
        return (v == 0).to(torch.int64)
    if name in ("NEG_I", "NEG_F"):
        return -v
    if name in ("ABS_I", "ABS_F"):
        return torch.abs(v)
    if name == "FN_F":
        return _double_fn(FN_F[arg], v)
    if name == "FPRED_F":
        return {"is_nan": torch.isnan, "is_finite": torch.isfinite,
                "is_infinite": torch.isinf}[FPRED_F[arg]](v).to(torch.int64)
    if name == "SIGN_I":
        return torch.sign(v)
    if name == "SIGN_F":
        return torch.where(torch.isnan(v), v, torch.sign(v))   # jnp.sign
    if name == "CEILD_I":
        return -_floor_div(-v, arg)
    if name == "FLOORD_I":
        return _floor_div(v, arg)
    if name == "ROUNDD_I":
        # to a multiple of arg, half away from zero (the reference's round)
        return torch.sign(v) * _floor_div(torch.abs(v) + arg // 2, arg) * arg
    if name == "ROUND_F":
        # SQL rounds half AWAY from zero: sign * floor(|v| * s + 0.5) / s
        scale = _bits_float(arg)
        return torch.sign(v) * torch.floor(torch.abs(v) * scale + 0.5) \
            / scale
    if name == "BNOT":
        return ~v
    if name in ("DOW", "DOY", "WEEK", "DTRUNC"):
        return _date_part(name, arg, v)
    y, m, d = civil_from_days(v)
    return {"YEAR": y, "MONTH": m, "DAY": d,
            "QUARTER": _floor_div(m + 2, 3)}[name]


def _double_fn(fn: str, v):
    """FN_F: the reference's jnp function of one double."""
    if fn == "ln":
        return torch.log(v)
    if fn in ("log2", "log10"):
        # jnp.log(v) / jnp.log(2.0 | 10.0), as the reference divides
        return torch.log(v) / math.log(2.0 if fn == "log2" else 10.0)
    if fn == "cbrt":
        return torch.sign(v) * torch.abs(v).pow(1.0 / 3.0)
    if fn == "degrees":
        return v * (180.0 / math.pi)
    if fn == "radians":
        return v * (math.pi / 180.0)
    return getattr(torch, fn)(v)


def _binary_fn(name: str, arg: int, a, b):
    """The binary forms of the scalar function set: (values, rows the
    call itself makes NULL or None)."""
    if name == "FN2_F":
        fn = FN2_F[arg]
        if fn == "power":
            return torch.pow(a, b), None
        if fn == "log":                 # log(base a, x b)
            return torch.log(b) / torch.log(a), None
        return torch.atan2(a, b), None
    if name in ("MAX_I", "MAX_F", "MIN_I", "MIN_F"):
        big = name.startswith("MAX")
        out = torch.maximum(a, b) if big else torch.minimum(a, b)
        if name.endswith("_F"):
            # jnp.maximum / minimum order -0.0 below 0.0 (torch returns
            # the first of two equal zeros)
            zero = (a == 0) & (b == 0)
            neg = (torch.signbit(a) & torch.signbit(b)) if big \
                else (torch.signbit(a) | torch.signbit(b))
            out = torch.where(zero, torch.where(neg, -0.0, 0.0).to(
                out.dtype), out)
        return out, None
    if name == "DADD":                  # date_add(unit, n a, date b)
        unit = DATE_UNITS[arg]
        if unit in ("day", "week"):
            return b + a * (7 if unit == "week" else 1), None
        return _add_months(b, a * {"month": 1, "quarter": 3,
                                   "year": 12}[unit]), None
    if name == "DDIFF":
        return _date_diff(DATE_UNITS[arg], a, b), None
    if name == "BAND":
        return a & b, None
    if name == "BOR":
        return a | b, None
    if name == "BXOR":
        return a ^ b, None
    # shifts: a count >= 64 shifts everything out (0, or the sign fill of
    # an arithmetic right shift); a negative count makes the row NULL
    big = b >= 64
    sh = b.clamp(0, 63)
    zero = torch.zeros_like(a)
    if name == "SHL":
        out = torch.where(big, zero, a << sh)
    elif name == "SAR":
        out = a >> torch.where(big, torch.full_like(sh, 63), sh)
    else:                               # logical: the sign fill masked off
        mask = (torch.ones_like(sh) << (64 - sh).clamp(max=63)) - 1
        out = torch.where(big, zero,
                          torch.where(sh == 0, a, (a >> sh) & mask))
    return out, b < 0


def _width_bucket(x, lo, hi, n):
    """width_bucket(x, lo, hi, n) over doubles x, lo, hi and an integer
    n: the reference's formula, its 1-ulp nudge before the floor, and
    NULL where n <= 0."""
    span = torch.where(hi == lo, torch.ones_like(hi), hi - lo)
    v = (x - lo) * n.to(torch.float64) / span
    bucket = _saturating_int(torch.floor(v * (1 + 2.0 ** -40)), 64) + 1
    top = torch.clamp(n + 1, min=0)
    return torch.minimum(torch.clamp(bucket, min=0), top), n <= 0


def days_from_civil(y, m, d):
    """(year, month, day) -> days since the epoch: the reference's
    _days_from_civil, the inverse of civil_from_days."""
    y = y - (m <= 2).to(y.dtype)
    era = _floor_div(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floor_div(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floor_div(yoe, 4) - _floor_div(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _dow(days):
    return torch.remainder(days + 3, 7) + 1


def _iso_weeks_in_year(y):
    """52 or 53 (ISO-8601): 53 iff Jan 1 or Dec 31 is a Thursday."""
    one = torch.ones_like(y)
    jan1 = days_from_civil(y, one, one)
    dec31 = days_from_civil(y, one * 12, one * 31)
    thu = (_dow(jan1) == 4) | (_dow(dec31) == 4)
    return torch.where(thu, 53, 52)


def _date_part(name: str, arg: int, days):
    """DOW / DOY / WEEK (ISO, with the wrap at Jan 1 and Dec 28-31) and
    DTRUNC to DATE_UNITS[arg] (any unit but day, week, quarter and year
    truncates to the month, as the reference does)."""
    if name == "DOW":
        return _dow(days)
    if name == "DTRUNC" and DATE_UNITS[arg] == "day":
        return days
    if name == "DTRUNC" and DATE_UNITS[arg] == "week":
        return days - torch.remainder(days + 3, 7)
    y, m, _d = civil_from_days(days)
    one = torch.ones_like(m)
    if name == "DTRUNC":
        unit = DATE_UNITS[arg]
        if unit == "quarter":
            m = _floor_div(m - 1, 3) * 3 + 1
        elif unit == "year":
            m = one
        return days_from_civil(y, m, one)
    doy = days - days_from_civil(y, one, one) + 1
    if name == "DOY":
        return doy
    w0 = _floor_div(10 + doy - _dow(days), 7)
    # nested on the original w: a w0 < 1 resolved to last year's 53 is
    # not re-clamped by this year's week count
    return torch.where(w0 < 1, _iso_weeks_in_year(y - 1),
                       torch.where(w0 > _iso_weeks_in_year(y),
                                   torch.ones_like(w0), w0))


def _add_months(days, months):
    """Calendar month addition clamped to the month's end (Presto's
    date_add: Jan 31 + 1 month = Feb 28 / 29)."""
    y, m, d = civil_from_days(days)
    one = torch.ones_like(m)
    total = (m - 1) + months
    first = days_from_civil(y + _floor_div(total, 12),
                            torch.remainder(total, 12) + 1, one)
    nxt = total + 1
    next_first = days_from_civil(y + _floor_div(nxt, 12),
                                 torch.remainder(nxt, 12) + 1, one)
    return first + torch.minimum(d, next_first - first) - 1


def _date_diff(unit: str, da, db):
    """db - da in whole units, truncated toward zero; a partial month
    does not count."""
    if unit in ("day", "week"):
        diff = db - da
        return torch.sign(diff) * _floor_div(
            torch.abs(diff), 7 if unit == "week" else 1)
    ya, ma, dda = civil_from_days(da)
    yb, mb, ddb = civil_from_days(db)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    months = torch.where((months > 0) & (ddb < dda), months - 1, months)
    months = torch.where((months < 0) & (ddb > dda), months + 1, months)
    den = {"month": 1, "quarter": 3, "year": 12}[unit]
    return torch.sign(months) * _floor_div(torch.abs(months), den)


def _reencode_table(mapped):
    """Entries mapped through a transform -> (int64 code table, sorted
    deduplicated dictionary), so codes stay rank codes."""
    uniq = tuple(sorted({s for s in mapped if s is not None}))
    index = {s: i for i, s in enumerate(uniq)}
    return [0 if s is None else index[s] for s in mapped], uniq or ("",)


def _concat(parts, n, device):
    """concat over dictionary slots and constants (the reference's
    _concat): a fold over one dictionary, or over the product of two (at
    most 65536 entries), re-encoded; NULL if any part is."""
    dicts = [d for _v, _nl, d in parts]
    if any(d is None for d in dicts):
        raise NotImplementedError("concat on non-dictionary varchar")
    multi = [i for i, d in enumerate(dicts) if len(d) > 1]
    if len(multi) > 2 or (len(multi) == 2 and len(dicts[multi[0]])
                          * len(dicts[multi[1]]) > 65536):
        raise NotImplementedError("concat dictionary product too large")
    nulls = None
    for _v, nl, _d in parts:
        if nl is not None:
            nulls = nl if nulls is None else nulls | nl
    if any(not d for d in dicts):
        # an empty dictionary has no value to show: all NULL
        return (torch.zeros(n, dtype=torch.int64, device=device),
                torch.ones(n, dtype=torch.bool, device=device), ("",))

    def build():
        if len(multi) <= 1:
            base = multi[0] if multi else 0
            mapped = ["".join(d[0] if i != base else s
                              for i, d in enumerate(dicts))
                      for s in dicts[base]]
        else:
            a, b = multi
            mapped = ["".join(sa if i == a else sb if i == b else d[0]
                              for i, d in enumerate(dicts))
                      for sa in dicts[a] for sb in dicts[b]]
        table, out_dict = _reencode_table(mapped)
        return torch.tensor(table, dtype=torch.int64, device=device), \
            out_dict
    table, out_dict = _memo(("concat", len(parts)), tuple(dicts), device,
                            build)
    if len(multi) <= 1:
        codes = parts[multi[0] if multi else 0][0]
    else:
        a, b = multi
        codes = parts[a][0] * len(dicts[b]) + parts[b][0]
    return table[codes], nulls, out_dict


def _saturating_int(v, bits: int):
    """A double as a `bits`-wide integer (held in int64), truncated toward
    zero, saturating at the bounds, NaN as 0 (XLA's convert, which the
    reference's astype runs)."""
    hi = float(1 << (bits - 1))
    t = torch.trunc(torch.nan_to_num(v, nan=0.0, posinf=hi, neginf=-hi))
    big, small = t >= hi, t < -hi
    out = torch.where(big | small, torch.zeros_like(t), t).to(torch.int64)
    out = torch.where(big, torch.full_like(out, (1 << (bits - 1)) - 1), out)
    return torch.where(small, torch.full_like(out, -(1 << (bits - 1))), out)


def program_nullable(ops, columns, nullable_cols, maps=()) -> bool:
    """Whether the program's result can be NULL, by the reference's static
    rule, walking its stack of may-be-NULL flags."""
    st: List[bool] = []
    i = 0
    while i < len(ops):
        op, arg = ops[i]
        i += 1
        name = OPS[op]
        if name == "COL":
            st.append(columns[arg] in nullable_cols)
        elif name in ("CONST_I", "CONST_F", "PARAM_I", "PARAM_F",
                      "CONST_S"):
            st.append(False)
        elif name in ("NULL_I", "NULL_F", "NULL_S", "ARR"):
            # an array form: an out-of-bounds subscript or an empty
            # array's max is NULL
            st.append(True)
        elif name in _UNARY:
            pass
        elif name == "MAP_S":
            # a string function may map an entry to NULL
            st[-1] = st[-1] or maps[arg][0] in ("substr", "str", "val")
        elif name == "IS_NULL":
            st[-1] = False
        elif name in ("IN_I", "IN_F"):
            i += arg
        elif name in ("IF", "IF_S"):
            f, t, _c = st.pop(), st.pop(), st.pop()
            st.append(t or f)
        elif name in ("CONCAT_S", "WBUCKET"):
            k = arg if name == "CONCAT_S" else 4
            flags = st[-k:]
            del st[-k:]
            st.append(any(flags) or name == "WBUCKET")
        elif name == "DADD":
            b, _a = st.pop(), st.pop()
            st.append(b)
        elif name == "COALESCE":
            b, a = st.pop(), st.pop()
            st.append(a and b)
        else:
            b, a = st.pop(), st.pop()
            st.append(a or b or name in _NULLING)
    return st[-1]


def _narrow_bits(ta: Type, tb: Type) -> int:
    """DIV_I / MOD_I / DIVQ_I's argument: which operands are int32."""
    def narrow(t):
        return isinstance(t, (IntegerType, DateType))
    return int(narrow(ta)) | int(narrow(tb)) << 1


def _is_varchar(t: Type) -> bool:
    return isinstance(t, (VarcharType, CharType))


def _domain_is_float(t: Type) -> bool:
    """Whether `t` lives in a program's float64 slots: DOUBLE, and REAL,
    whose float32 values a slot holds exactly (a REAL result column is
    rounded back to float32 when the program stores it)."""
    return isinstance(t, (DoubleType, RealType))


class _Emitter:
    """Recursive RowExpression -> ExprProgram compiler."""

    def __init__(self):
        self.ops: List[Tuple[int, int]] = []
        self.columns: Dict[str, int] = {}
        self.depth = 0
        self.max_depth = 0
        self.uses_params = False
        self.strings: List[str] = []
        self.maps: List[tuple] = []
        self.arrays: List[ArrayNode] = []

    def _array(self, expr: RowExpression) -> None:
        """An array form as an ARR slot (its ArrayNode evaluated before
        the program)."""
        node = array_node(expr)
        if node not in self.arrays:
            self.arrays.append(node)
        self._op("ARR", self.arrays.index(node), +1)

    def _op(self, name: str, arg: int = 0, delta: int = 0):
        self.ops.append((OP[name], int(arg)))
        self.depth += delta
        self.max_depth = max(self.max_depth, self.depth)

    def emit(self, expr: RowExpression) -> None:
        if isinstance(expr.type, ArrayType) or (
                isinstance(expr, CallExpression)
                and canonical_name(expr.display_name) in ARRAY_FNS):
            self._array(expr)
        elif isinstance(expr, VariableReferenceExpression):
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
            self._special(expr)
        else:
            raise NotImplementedError(
                f"{type(expr).__name__} is not ported yet")

    def _emit_as(self, expr: RowExpression, is_f: bool) -> None:
        """`expr` in the integer or double domain of a select's result:
        an integer slot joins a double one by value, as jnp.where
        promotes it."""
        if isinstance(expr.type, (VarcharType, CharType)):
            raise NotImplementedError(
                "varchar operands of IF / COALESCE / NULL_IF in the port")
        self.emit(expr)
        if _domain_is_float(expr.type) == is_f:
            return
        if not is_f:
            raise NotImplementedError("a double operand of an exact select")
        self._op("I2F")

    def _map(self, spec: tuple) -> None:
        """A per-code fold of the top (dictionary) slot (MAP_S)."""
        if spec not in self.maps:
            self.maps.append(spec)
        self._op("MAP_S", self.maps.index(spec))

    def _special(self, expr: SpecialFormExpression) -> None:
        """The reference's _special: Kleene AND / OR, IS_NULL, IF (what the
        planner makes of CASE), COALESCE, NULL_IF and IN."""
        form, args = expr.form, expr.arguments
        if form in ("AND", "OR"):
            self.emit(args[0])
            for a in args[1:]:
                self.emit(a)
                self._op(form, 0, -1)
        elif form == "IS_NULL":
            self.emit(args[0])
            self._op("IS_NULL")
        elif form == "IF" and _is_varchar(expr.type):
            # two dictionaries merge onto their union (IF_S)
            for a in args:
                self.emit(a)
            self._op("IF_S", 0, -2)
        elif form == "IF":
            is_f = _domain_is_float(expr.type)
            self.emit(args[0])
            self._emit_as(args[1], is_f)
            self._emit_as(args[2], is_f)
            self._op("IF", 0, -2)
        elif form == "COALESCE":
            self._coalesce(args, expr.type)
        elif form == "NULL_IF":
            fa, fb = (_domain_is_float(a.type) for a in args)
            if fa != fb:
                # compared in float64, the first operand's value kept
                self._emit_as(args[0], fa)
                self._emit_as(args[1], fb)
                self._op("NULLIF_X", 0, -1)
                return
            self._emit_as(args[0], fa)
            self._emit_as(args[1], fa)
            self._op("NULLIF_F" if fa else "NULLIF_I", 0, -1)
        elif form == "IN":
            self._in(args[0], args[1:])
        else:
            raise NotImplementedError(
                f"special form {form} is not ported yet")

    def _coalesce(self, args, typ: Type) -> None:
        # a left fold: coalesce(coalesce(a, b), c) picks the same value and
        # NULL flag as the reference's right fold, with two stack slots
        is_f = _domain_is_float(typ)
        self._emit_as(args[0], is_f)
        for a in args[1:]:
            self._emit_as(a, is_f)
            self._op("COALESCE", 0, -1)

    def _in(self, value: RowExpression, items) -> None:
        """The reference's _in over a numeric value: each constant in the
        value's domain (constant_device_value with the VALUE's type, as
        the reference converts it), compared for equality; the value's
        NULLs stay, and a NULL-free list never makes one."""
        if not all(isinstance(e, ConstantExpression) for e in items):
            raise NotImplementedError("IN with a non-constant list")
        if _is_varchar(value.type):
            # a per-code membership table; the reference matches each
            # constant's str() (a NULL constant is the string 'None')
            self.emit(value)
            self._map(("in", frozenset(str(e.value) for e in items)))
            return
        # a NULL constant matches nothing (the reference compares the
        # values with None, which is False) and leaves misses non-NULL
        consts = [c for c in (constant_device_value(e.value, value.type)
                              for e in items) if c is not None]
        if not all(isinstance(c, (bool, int, float)) for c in consts):
            raise NotImplementedError("IN with a non-numeric constant")
        is_f = _domain_is_float(value.type) or any(
            isinstance(c, float) for c in consts)
        self.emit(value)
        if is_f and not _domain_is_float(value.type):
            self._op("I2F")
        self._op("IN_F" if is_f else "IN_I", len(consts))
        for c in consts:
            self._op("LIT", float_bits(c) if is_f else int(c))

    def _constant(self, expr: ConstantExpression) -> None:
        if _is_varchar(expr.type):
            # a one-entry dictionary, code 0 on every row
            if expr.value is None:
                self._op("NULL_S", 0, +1)
                return
            v = str(constant_device_value(expr.value, expr.type))
            if v not in self.strings:
                self.strings.append(v)
            self._op("CONST_S", self.strings.index(v), +1)
            return
        is_f = _domain_is_float(expr.type)
        if expr.value is None:
            self._op("NULL_F" if is_f else "NULL_I", 0, +1)
            return
        v = constant_device_value(expr.value, expr.type)
        if isinstance(expr.type, RealType):
            v = float(np.float32(v))
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
            if isinstance(target, RealType) \
                    and not isinstance(typ, RealType):
                # the reference converts the operand to float32
                self._op("F2R")

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
        elif name in ("negate", "abs"):
            self.emit(args[0])
            is_f = _domain_is_float(args[0].type)
            self._op(("NEG" if name == "negate" else "ABS")
                     + ("_F" if is_f else "_I"))
            if not is_f and isinstance(expr.type, (IntegerType, DateType)):
                self._op("WRAP32")     # int32 negation / abs wrap
        elif name in _DATE_PARTS:
            if not isinstance(args[0].type, DateType):
                raise NotImplementedError(
                    f"{name} of {args[0].type} is not ported yet")
            self.emit(args[0])
            self._op(name.upper())
        elif name == "coalesce":
            self._coalesce(args, expr.type)
        elif name == "cast":
            self._cast(args[0], expr.type)
        elif name == "concat":
            for a in args:
                if not _is_varchar(a.type):
                    raise NotImplementedError(
                        "concat on non-dictionary varchar")
                self.emit(a)
            self._op("CONCAT_S", len(args), 1 - len(args))
        elif name in ("like", "substr") or name in STRING_TO_STRING \
                or name in STRING_TO_VALUE:
            self._string_fn(name, args)
        elif name in _DATE_FNS:
            self._date_fn(name, args)
        else:
            self._math_fn(name, expr)

    def _double(self, expr: RowExpression) -> None:
        """`expr` converted to a double (the reference's
        _to_common_numeric with a DOUBLE target)."""
        from ..common.types import DOUBLE
        self.emit(expr)
        self._convert(expr.type, DOUBLE)

    def _math_fn(self, name: str, expr: CallExpression) -> None:
        """The reference's math and bitwise functions (Lowering._call)."""
        args = expr.arguments
        if name in FN_F and name not in ("ceil", "floor", "trunc"):
            self._double(args[0])
            self._op("FN_F", FN_F.index(name))
        elif name in FN2_F:
            self._double(args[0])
            self._double(args[1])
            self._op("FN2_F", FN2_F.index(name), -1)
        elif name in FPRED_F:
            self._double(args[0])
            self._op("FPRED_F", FPRED_F.index(name))
        elif name in ("ceiling", "ceil", "floor"):
            t = args[0].type
            self.emit(args[0])
            up = name != "floor"
            if _domain_is_float(t):
                self._op("FN_F", FN_F.index("ceil" if up else "floor"))
            elif _is_decimal(t) and t.scale > 0:
                self._op("CEILD_I" if up else "FLOORD_I", 10 ** t.scale)
        elif name == "sign":
            self.emit(args[0])
            self._op("SIGN_F" if _domain_is_float(args[0].type)
                     else "SIGN_I")
        elif name == "truncate":
            self._double(args[0])
            self._op("FN_F", FN_F.index("trunc"))
        elif name == "round":
            self._round(expr)
        elif name in ("greatest", "least"):
            if _is_varchar(expr.type):
                raise NotImplementedError(f"{name} over varchar")
            suffix = "_F" if _domain_is_float(expr.type) else "_I"
            for i, a in enumerate(args):
                self.emit(a)
                self._convert(a.type, expr.type)
                if i:
                    self._op(("MAX" if name == "greatest" else "MIN")
                             + suffix, 0, -1)
        elif name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                      "bitwise_left_shift", "bitwise_right_shift",
                      "bitwise_arithmetic_shift_right"):
            for a in args:
                if _domain_is_float(a.type):
                    raise NotImplementedError(f"{name} of a double")
                self.emit(a)
            self._op(_BITWISE[name], 0, -1)
        elif name == "bitwise_not":
            self.emit(args[0])
            self._op("BNOT")
        elif name == "width_bucket":
            for a in args[:3]:
                self._double(a)
            self.emit(args[3])
            self._op("WBUCKET", 0, -3)
        else:
            raise NotImplementedError(
                f"function {name} is not ported yet")

    def _round(self, expr: CallExpression) -> None:
        """round(x [, digits]): decimals and doubles half away from
        zero (the reference's round)."""
        args = expr.arguments
        if len(args) > 1 and not isinstance(args[1], ConstantExpression):
            raise NotImplementedError("round with non-constant digits")
        digits = int(args[1].value) if len(args) > 1 else 0
        t = args[0].type
        if _is_decimal(expr.type):
            s = t.scale if _is_decimal(t) else 0
            self.emit(args[0])
            if digits < s:
                self._op("ROUNDD_I", 10 ** (s - digits))
            self._rescale(s, expr.type.scale)
            return
        self._double(args[0])
        self._op("ROUND_F", float_bits(10.0 ** digits))
        if not _domain_is_float(expr.type):
            # back to the argument's integer type, as XLA converts
            self._op("F2I", 32 if torch_dtype(t) == torch.int32 else 64)

    def _date_fn(self, name: str, args) -> None:
        """The reference's _date_fn: day_of_week, day_of_year, ISO week,
        date_trunc, date_add and date_diff over days since the epoch."""
        if name in ("day_of_week", "day_of_year", "week"):
            self.emit(args[0])
            self._op({"day_of_week": "DOW", "day_of_year": "DOY",
                      "week": "WEEK"}[name])
            return
        if not isinstance(args[0], ConstantExpression):
            raise NotImplementedError(f"{name} with a non-constant unit")
        unit = str(args[0].value).lower()
        if name == "date_trunc":
            self.emit(args[1])
            self._op("DTRUNC", DATE_UNITS.index(unit)
                     if unit in DATE_UNITS else DATE_UNITS.index("month"))
            return
        if unit not in DATE_UNITS:
            raise NotImplementedError(f"{name} unit {unit!r}")
        self.emit(args[1])
        self.emit(args[2])
        self._op("DADD" if name == "date_add" else "DDIFF",
                 DATE_UNITS.index(unit), -1)

    def _string_fn(self, name: str, args) -> None:
        """A function of a dictionary column and constants, folded per
        code (the reference's _like, _substr and _string_fn)."""
        if not _is_varchar(args[0].type):
            raise NotImplementedError(f"{name} on non-dictionary varchar")
        if not all(isinstance(a, ConstantExpression) for a in args[1:]):
            raise NotImplementedError(f"{name} with non-constant arguments")
        extra = tuple(a.value for a in args[1:])
        self.emit(args[0])
        if name == "like":
            # the reference's _like reads the pattern alone
            self._map(("like", str(extra[0])))
        elif name == "substr":
            self._map(("substr",) + tuple(int(x) for x in extra))
        elif name in STRING_TO_STRING:
            self._map(("str", name, extra))
        else:
            self._map(("val", name, extra))

    def _arith(self, name: str, expr: CallExpression) -> None:
        """The reference's _arith: the double domain converts both
        operands; decimals align scales (a divide scales its numerator to
        the result's scale plus the divisor's, then rounds half up); the
        integer domain divides truncating toward zero."""
        a, b = expr.arguments
        ta, tb, tr = a.type, b.type, expr.type
        if _domain_is_float(tr):
            for e, t in ((a, ta), (b, tb)):
                self.emit(e)
                self._convert(t, tr)
            self._op(_ARITH[name] + "_F", 0, -1)
            if isinstance(tr, RealType):
                # float32 arithmetic: the float64 result of two float32
                # values rounds to the correctly rounded float32 result
                # (+ - * / carry at least 2 * 24 + 2 bits in float64);
                # never planned (REAL arithmetic is typed DOUBLE), only
                # IR typed REAL by hand, as the module docstring says
                self._op("F2R")
            return
        if _domain_is_float(ta) or _domain_is_float(tb):
            raise NotImplementedError(
                f"{name} of a double operand into an exact result")
        if _is_decimal(tr):
            sa = ta.scale if _is_decimal(ta) else 0
            sb = tb.scale if _is_decimal(tb) else 0
            if name == "multiply":
                self.emit(a)
                self.emit(b)
                self._op("MUL_I", 0, -1)
                self._rescale(sa + sb, tr.scale)
                return
            if name == "divide":
                self.emit(a)
                bits, up = _narrow_bits(ta, tb), tr.scale + sb - sa
                if up > 0 and not bits & 1:
                    # the scale-up inside the divide (DIVQS_I): exact
                    # where the reference's int64 rescale would wrap
                    self.emit(b)
                    self._op("DIVQS_I", bits | up << 2, -1)
                    return
                self._rescale(sa, tr.scale + sb)
                self.emit(b)
                self._op("DIVQ_I", bits, -1)
                return
            self.emit(a)
            self._rescale(sa, tr.scale)
            self.emit(b)
            self._rescale(sb, tr.scale)
            self._op(_ARITH[name] + "_I",
                     _narrow_bits(ta, tb) if name == "modulus" else 0, -1)
            return
        self.emit(a)
        self.emit(b)
        self._op(_ARITH[name] + "_I", _narrow_bits(ta, tb)
                 if name in ("divide", "modulus") else 0, -1)
        if isinstance(tr, (IntegerType, DateType)):
            self._op("WRAP32")     # int32 arithmetic wraps at 32 bits

    def _compare(self, name: str, a: RowExpression, b: RowExpression) -> None:
        if _is_varchar(a.type) or _is_varchar(b.type):
            # codes against a literal, each other or a remap (CMP_S)
            self.emit(a)
            self.emit(b)
            self._op("CMP_S", _CMP.index(name), -1)
            return
        common = _common_super(a.type, b.type)
        for e in (a, b):
            self.emit(e)
            self._convert(e.type, common)
        suffix = "_F" if _domain_is_float(common) else "_I"
        self._op(name.upper() + suffix, 0, -1)

    def _cast(self, arg: RowExpression, to: Type) -> None:
        """The reference's _cast over the numeric types.  A decimal cast
        to INTEGER keeps its UNSCALED value, wrapped to 32 bits
        (presto_tpu/exec/lowering.py _cast), where Presto rescales."""
        frm = arg.type
        self.emit(arg)
        if frm.signature == to.signature \
                or (_is_varchar(frm) and _is_varchar(to)):
            return
        if isinstance(to, RealType) and (_is_varchar(frm) or isinstance(
                frm, (BooleanType, DateType, ArrayType))):
            raise NotImplementedError(f"cast {frm} -> {to} is not ported yet")
        if isinstance(to, (DoubleType, RealType)):
            self._convert(frm, to)
        elif _is_decimal(to) and _domain_is_float(frm):
            self._op("MULC_F", float_bits(float(10 ** to.scale)))
            self._op("RINT_I")         # jnp.round: half to even
        elif _is_decimal(to):
            self._convert(frm, to)
        elif isinstance(to, IntegerType) and not _domain_is_float(frm):
            self._op("WRAP32")
        elif isinstance(to, BigintType) and not _domain_is_float(frm):
            if _is_decimal(frm):
                self._rescale(frm.scale, 0)
        elif isinstance(to, (IntegerType, BigintType)) \
                and _domain_is_float(frm):
            self._op("F2I", 32 if isinstance(to, IntegerType) else 64)
        else:
            raise NotImplementedError(f"cast {frm} -> {to} is not ported yet")


# ---------------------------------------------------------------------------
# array forms over the padded (capacity, W) element matrix
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrayNode:
    """An array function (or an ARRAY column, `fn` "col") compiled for
    evaluation over whole columns: `args` are ArrayNodes (array
    arguments), ExprPrograms (scalar arguments) and, for repeat's count
    and sequence's bounds, ints.  The reference's Lowering._array_fn:
    element NULLs inside arrays are not represented, and Presto's
    out-of-bounds subscript ERROR is NULL (element_at semantics)."""
    fn: str
    args: Tuple[Union["ArrayNode", ExprProgram, int, str], ...]

    @property
    def uses_params(self) -> bool:
        return any(a.uses_params for a in self.args
                   if isinstance(a, (ArrayNode, ExprProgram)))

    def eval(self, columns: Dict[str, Column], n: int, params,
             device) -> Column:
        fn, args = self.fn, self.args

        def scalar(i: int) -> Column:
            return args[i].run(columns, n, params, device)
        if fn == "col":
            c = columns[args[0]]
            if c.lengths is None:
                raise NotImplementedError(f"{args[0]} is not an array")
            return c
        if fn == "array_constructor":
            if not args:
                return Column(torch.zeros((n, 0), dtype=torch.int64,
                                          device=device), None, None, None,
                              torch.zeros(n, dtype=torch.int32,
                                          device=device))
            cols = [scalar(i) for i in range(len(args))]
            if any(c.dictionary is not None or c.lazy is not None
                   or c.lengths is not None for c in cols):
                raise NotImplementedError(
                    "array elements must be scalar numerics")
            if any(c.nulls is not None for c in cols):
                raise NotImplementedError(
                    "NULL array elements not supported")
            dt = functools.reduce(torch.promote_types,
                                  [c.values.dtype for c in cols])
            vals = torch.stack([c.values.to(dt) for c in cols], dim=1)
            return Column(vals, None, None, None,
                          torch.full((n,), len(cols), dtype=torch.int32,
                                     device=device))
        if fn == "repeat":
            # repeat(x, k): a negative count clamps to the empty array
            # (Presto errors; the reference clamps)
            elem, k = scalar(0), max(args[1], 0)
            vals = elem.values[:, None].expand(n, max(k, 1))[:, :k]
            return Column(vals.contiguous(), elem.nulls, None, None,
                          torch.full((n,), k, dtype=torch.int32,
                                     device=device))
        if fn == "sequence":
            lo, hi, step = args
            seq = torch.arange(lo, hi + (1 if step > 0 else -1), step,
                               dtype=torch.int64, device=device)
            return Column(seq[None, :].expand(n, seq.shape[0]).contiguous(),
                          None, None, None,
                          torch.full((n,), seq.shape[0], dtype=torch.int32,
                                     device=device))
        arr = args[0].eval(columns, n, params, device)
        if arr.lengths is None:
            raise NotImplementedError(f"{fn} on non-array input")
        W = arr.values.shape[1]
        lens = arr.lengths.to(torch.int64)
        if fn == "cardinality":
            return Column(lens, arr.nulls)
        if fn in ("subscript", "element_at"):
            idx = scalar(1)
            raw = idx.values.to(torch.int64)
            if fn == "element_at":
                # element_at(-k) indexes from the end
                raw = torch.where(raw < 0, lens + raw + 1, raw)
            i0 = raw - 1                                    # 1-based
            oob = (i0 < 0) | (i0 >= lens)
            if W == 0:
                out = torch.zeros(n, dtype=arr.values.dtype, device=device)
            else:
                safe = i0.clamp(0, W - 1)
                out = torch.gather(arr.values, 1, safe[:, None])[:, 0]
            nulls = oob | arr.null_mask()
            if idx.nulls is not None:
                nulls = nulls | idx.nulls
            return Column(out, nulls)
        live = torch.arange(W, device=device)[None, :] < lens[:, None]
        if fn in ("contains", "array_position"):
            x = scalar(1)
            eq = live & (arr.values == x.values[:, None])
            if fn == "contains":
                out = eq.any(dim=1)
            else:
                out = torch.where(eq.any(dim=1), eq.to(torch.int8)
                                  .argmax(dim=1) + 1, 0).to(torch.int64) \
                    if W else torch.zeros(n, dtype=torch.int64,
                                          device=device)
            nulls = arr.nulls
            if x.nulls is not None:
                nulls = x.nulls if nulls is None else nulls | x.nulls
            return Column(out, nulls)
        if fn in ("array_max", "array_min"):
            v = arr.values
            if v.is_floating_point():
                big = math.inf
            else:
                big = torch.iinfo(v.dtype).max
            ident = big if fn == "array_min" else (
                -big if v.is_floating_point() else torch.iinfo(v.dtype).min)
            masked = torch.where(live, v, torch.full_like(v, ident))
            if W:
                out = (masked.amin(dim=1) if fn == "array_min"
                       else masked.amax(dim=1))
            else:
                out = torch.zeros(n, dtype=v.dtype, device=device)
            return Column(out, (lens == 0) | arr.null_mask())
        raise NotImplementedError(fn)


def array_node(expr: RowExpression) -> ArrayNode:
    """An array form compiled to its ArrayNode: its scalar arguments as
    ExprPrograms, repeat's count and sequence's bounds as constants."""
    if isinstance(expr, VariableReferenceExpression):
        return ArrayNode("col", (expr.name,))
    if not isinstance(expr, CallExpression):
        raise NotImplementedError(
            f"array value from {type(expr).__name__}")
    fn = canonical_name(expr.display_name)
    args = expr.arguments
    if fn not in ARRAY_FNS:
        raise NotImplementedError(f"array value from function {fn}")
    if fn == "array_constructor":
        for a in args:
            if isinstance(a.type, ArrayType) or _is_varchar(a.type):
                raise NotImplementedError(
                    "array elements must be scalar numerics")
        return ArrayNode(fn, tuple(compile_expr(a) for a in args))
    if fn == "repeat":
        if not isinstance(args[1], ConstantExpression):
            raise NotImplementedError("repeat with non-constant count")
        return ArrayNode(fn, (compile_expr(args[0]), int(args[1].value)))
    if fn == "sequence":
        if not all(isinstance(a, ConstantExpression) for a in args):
            raise NotImplementedError("sequence with non-constant bounds")
        lo, hi = int(args[0].value), int(args[1].value)
        step = int(args[2].value) if len(args) > 2 else 1
        return ArrayNode(fn, (lo, hi, step))
    rest = tuple(compile_expr(a) for a in args[1:])
    return ArrayNode(fn, (array_node(args[0]),) + rest)


def compile_expr(expr: RowExpression, nullable_cols=()) -> ExprProgram:
    """`expr` as an ExprProgram; `nullable_cols` names the input columns
    that can hold NULLs (for ExprProgram.nullable)."""
    em = _Emitter()
    em.emit(expr)
    if em.max_depth > MAX_STACK:
        raise NotImplementedError(
            f"expression needs {em.max_depth} stack slots "
            f"(the kernel interpreter keeps {MAX_STACK})")
    cols = tuple(sorted(em.columns, key=em.columns.get))
    ops = tuple(em.ops)
    maps = tuple(em.maps)
    dtype = (torch.int32 if _is_varchar(expr.type)
             else torch.int64 if isinstance(expr.type, ArrayType)
             else torch_dtype(expr.type))
    return ExprProgram(ops, cols, _domain_is_float(expr.type), dtype,
                       em.max_depth, em.uses_params
                       or any(a.uses_params for a in em.arrays),
                       program_nullable(ops, cols, frozenset(nullable_cols),
                                        maps),
                       tuple(em.strings), maps, tuple(em.arrays))


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
        # a scalar argument of an array form reads the batch's columns
        return self.compile(expr).run(batch.columns, batch.capacity,
                                      batch.params, batch.device)
