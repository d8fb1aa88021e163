"""Row comparison of two QueryResults, for the port's parity tests and
the chip script's torch-chain phase: integers, decimals and strings
exactly, floats within a stated relative tolerance (1e-12 unless a
caller states another).

zero_tol, where a test states one, is for a sort-path stddev / variance
of a group whose values are all equal: its M2 is 0, but both packages
take it as a difference of two prefix sums, whose rounding residual
(at most eps x the prefix) leaves a tiny positive value or, under the
square root of a negative residual, NaN -- in either package, at
positions that depend on the float order.  Two such values (NaN or
below zero_tol in magnitude) compare equal."""
import math


def values_close(a, b, rtol: float = 1e-12,
                 zero_tol: float = 0.0) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if fa == fb or (math.isnan(fa) and math.isnan(fb)):
            return True
        if zero_tol and all(math.isnan(v) or abs(v) < zero_tol
                            for v in (fa, fb)):
            return True
        return abs(fa - fb) <= rtol * max(abs(fa), abs(fb))
    return a == b


def assert_rows_close(got, exp, ordered: bool, rtol: float = 1e-12,
                      zero_tol: float = 0.0) -> None:
    """`got` and `exp` are QueryResults: the port's and the one it is
    held against."""
    g = got.rows if ordered else sorted(got.rows, key=_key)
    e = exp.rows if ordered else sorted(exp.rows, key=_key)
    assert len(g) == len(e), (len(g), len(e), g[:5], e[:5])
    for i, (rg, re_) in enumerate(zip(g, e)):
        assert len(rg) == len(re_), (i, rg, re_)
        for j, (a, b) in enumerate(zip(rg, re_)):
            assert values_close(a, b, rtol, zero_tol), (i, j, a, b, rg, re_)


def _key(row):
    # NULLs first, then by value; floats rounded so last-bit differences
    # cannot reorder rows (NaN as 0)
    return tuple((v is not None,
                  (0.0 if v != v else round(v, 6)) if isinstance(v, float)
                  else v)
                 for v in row)


# -- golden rows: a JSON form of result rows ------------------------------
# ints, strings and NULL as themselves; a float as {"f": repr(x)} (exact
# round trip, NaN and infinities included); a Decimal as {"dec": str(x)}

def encode_value(v):
    import decimal
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return {"f": repr(v)}
    if isinstance(v, decimal.Decimal):
        return {"dec": str(v)}
    raise TypeError(f"no golden form for {type(v).__name__} {v!r}")


def decode_value(v):
    import decimal
    if isinstance(v, dict):
        if "f" in v:
            return float(v["f"])
        return decimal.Decimal(v["dec"])
    return v


def golden_result(entry: dict):
    """A golden file's entry as an object with .rows (assert_rows_close's
    argument)."""
    class _Rows:
        rows = [[decode_value(x) for x in r] for r in entry["rows"]]
    return _Rows
