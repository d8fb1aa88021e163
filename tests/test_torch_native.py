"""The port's native string kernels (presto_tpu_torch/native: its own
copy of kernels.cpp, built with g++ into build/presto_tpu_torch/native)
against the Python loops that stay as their plain versions and against
the JAX package's native library, on strings made from a seed; the
whole-column hoists of exec/pipeline.py through the library, counted in
native.CALLS; and load(require=True) raising when the build fails."""
import numpy as np
import pytest

from presto_tpu import native as jnative
from presto_tpu_torch import native
from presto_tpu_torch.exec import pipeline
from presto_tpu_torch.exec.lowering import like_matcher
from torch_threads import one_torch_thread  # noqa: F401

PATTERNS = ["%green%", "PROMO%", "%BRASS", "a_c%", "%%", "", "_", "%x_y%",
            "%special%requests%", "abc"]


def _strings(seed: int, n: int = 3000):
    rng = np.random.default_rng(seed)
    alphabet = list("abcxyz_%GREN PROMOBRAS")
    out = ["".join(rng.choice(alphabet, rng.integers(0, 14)))
           for _ in range(n)]
    out[:4] = ["", "green", "PROMO BRUSHED", "a_c"]
    return out


def test_library_builds_under_build_dir():
    lib = native.load(require=True)
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parts[-4:-1] == ("build", "presto_tpu_torch", "native")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_match_equals_python_and_reference(pattern):
    strings = _strings(len(pattern))
    before = native.CALLS["like_match"]
    got = native.like_match(strings, pattern)
    assert native.CALLS["like_match"] == before + 1
    plain = pipeline.like_mask_plain(strings, like_matcher(pattern))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jnative.like_match(strings, pattern))


@pytest.mark.parametrize("start,length", [(1, 2), (3, None), (-2, None),
                                          (2, 5), (-4, 2)])
def test_substr_dict_encode_equals_python_and_reference(start, length):
    strings = _strings(abs(start) * 7 + (length or 0))
    cdict = tuple(sorted({pipeline._py_substr(s, start, length)
                          for s in strings}))
    index = {s: i for i, s in enumerate(cdict)}
    before = native.CALLS["substr_dict_encode"]
    got = native.substr_dict_encode(strings, start, length, cdict)
    assert native.CALLS["substr_dict_encode"] == before + 1
    np.testing.assert_array_equal(
        got, pipeline.substr_codes_plain(strings, start, length, index))
    np.testing.assert_array_equal(
        got, jnative.substr_dict_encode(strings, start, length, cdict))


def test_non_ascii_declines_to_python():
    before = dict(native.CALLS)
    assert native.like_match(["café"], "%f%") is None
    assert native.substr_dict_encode(["été"], 1, 1,
                                     ("é",)) is None
    assert native.CALLS == before


def test_pipeline_hoists_run_natively():
    """Q13's NOT LIKE over o_comment and Q22's substr(c_phone, 1, 2)
    through the whole-column hoists: the library's calls, rows equal to
    the JAX package's."""
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.benchmarks.tpch_queries import queries_for_sf
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    from torch_rows import assert_rows_close
    pipeline._LIKE_MASK_CACHE.clear()
    pipeline._SUBSTR_CODES_CACHE.clear()
    before = dict(native.CALLS)
    q = queries_for_sf(0.01)
    port = LocalQueryRunner("sf0.01", device="cpu")
    ref = JRunner("sf0.01")
    for n in (13, 22):
        assert_rows_close(port.execute(q[n]), ref.execute(q[n]),
                          ordered=True, rtol=1e-12)
    assert native.CALLS["like_match"] > before["like_match"]
    assert native.CALLS["substr_dict_encode"] > \
        before["substr_dict_encode"]


def test_require_raises_when_the_build_fails(tmp_path, monkeypatch):
    bad = tmp_path / "kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.load() is None
    with pytest.raises(RuntimeError, match="did not build"):
        native.load(require=True)
    assert native.like_match(["a"], "a") is None
