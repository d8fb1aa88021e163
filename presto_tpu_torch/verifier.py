"""Result verifier: checksum-based A/B comparison of two engines.

A host copy of presto_tpu/verifier.py.

The analog of presto-verifier (presto-verifier/.../framework/
AbstractVerification.java:74 + checksum/): each query runs on a *control*
runner and a *test* runner and the result sets are compared by per-column
checksums — order-insensitive, with floating point compared by count /
null-count / bounded-error mean rather than exact bits, exactly the
strategy the reference's ChecksumValidator family implements.

Typical pairings here: numpy reference interpreter vs the CUDA engine,
unconstrained engine vs forced-spill engine, local vs distributed runner.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Callable, Dict, List, Optional

MATCH = "MATCH"
MISMATCH = "MISMATCH"
CONTROL_ERROR = "CONTROL_ERROR"
TEST_ERROR = "TEST_ERROR"


@dataclass
class ColumnChecksum:
    count: int = 0
    nulls: int = 0
    # exact types: order-insensitive sum of value hashes (mod 2^64)
    hash_sum: int = 0
    # floats: compared by aggregates with tolerance
    float_sum: float = 0.0
    float_nan: int = 0

    def add(self, value, is_float: bool) -> None:
        self.count += 1
        if value is None:
            self.nulls += 1
            return
        if is_float:
            f = float(value)
            if math.isnan(f):
                self.float_nan += 1
            else:
                self.float_sum += f
            return
        h = hashlib.blake2b(repr(value).encode(), digest_size=8).digest()
        self.hash_sum = (self.hash_sum
                         + int.from_bytes(h, "little")) % (1 << 64)

    def matches(self, other: "ColumnChecksum",
                rel_tol: float = 1e-9) -> bool:
        if (self.count, self.nulls, self.float_nan) != \
                (other.count, other.nulls, other.float_nan):
            return False
        if self.hash_sum != other.hash_sum:
            return False
        scale = max(abs(self.float_sum), abs(other.float_sum), 1.0)
        return abs(self.float_sum - other.float_sum) <= rel_tol * scale


@dataclass
class VerificationResult:
    query: str
    status: str
    detail: str = ""
    control_checksums: List[ColumnChecksum] = field(default_factory=list)
    test_checksums: List[ColumnChecksum] = field(default_factory=list)


def checksum_result(result) -> List[ColumnChecksum]:
    """QueryResult -> per-column checksums, POSITIONAL (duplicate column
    names are common — 'select count(*), count(*)' — and must not
    collapse)."""
    from .common.types import DoubleType, RealType
    sums = [ColumnChecksum() for _ in result.column_names]
    flts = [isinstance(t, (DoubleType, RealType))
            for t in result.column_types]
    for row in result.rows:
        for cs, v, isf in zip(sums, row, flts):
            cs.add(_canonical(v), isf)
    return sums


def _canonical(v):
    if isinstance(v, Decimal):
        return str(v.normalize())
    if isinstance(v, bool):
        return int(v)
    return v


def verify(control: Callable[[str], object], test: Callable[[str], object],
           queries: List[str]) -> List[VerificationResult]:
    """Run every query through both engines and compare checksums.
    control/test: callables sql -> QueryResult."""
    out = []
    for sql in queries:
        try:
            c = control(sql)
        except Exception as e:  # noqa: BLE001 — verifier reports, not raises
            out.append(VerificationResult(sql, CONTROL_ERROR, repr(e)))
            continue
        try:
            t = test(sql)
        except Exception as e:  # noqa: BLE001
            out.append(VerificationResult(sql, TEST_ERROR, repr(e)))
            continue
        cc, tc = checksum_result(c), checksum_result(t)
        if c.column_names != t.column_names:
            out.append(VerificationResult(
                sql, MISMATCH,
                f"column sets differ: {c.column_names} vs {t.column_names}",
                cc, tc))
            continue
        bad = [f"{c.column_names[i]}#{i}" for i in range(len(cc))
               if not cc[i].matches(tc[i])]
        if bad:
            out.append(VerificationResult(
                sql, MISMATCH, f"checksum mismatch in columns {bad}", cc, tc))
        else:
            out.append(VerificationResult(sql, MATCH, "", cc, tc))
    return out
