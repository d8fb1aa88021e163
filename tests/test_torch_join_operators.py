"""The join slice's build and probe primitives against the reference
package, on seeded inputs that include NULL keys: the order-preserving
hash, the hash-sorted BuildTable, the DirectTable builder and lookup, the
semi-join markers, and kernel #5's plain version -- the torch appliers of
presto_tpu_torch/exec/kernels/join.py against the reference's
_make_applier called on jnp arrays.  Everything here is integer or boolean
and compared exactly; gathered float64 build columns compare bit for bit
(a gather does no arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import batch as jb
from presto_tpu.exec import fused as jfused
from presto_tpu.exec import operators as jops
from presto_tpu.exec.kernels import join as jjoin
from presto_tpu_torch.exec import batch as tb
from presto_tpu_torch.exec import fused as tfused
from presto_tpu_torch.exec import operators as tops
from presto_tpu_torch.exec.kernels import join as tjoin
from torch_threads import one_torch_thread  # noqa: F401

N = 3000


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _build_side(seed, key_dtype=np.int64, dense=True, dup=False,
                null_keys=True):
    """Host arrays of a build side: key `k` (dense or sparse, unique unless
    `dup`), a second key `k2`, a float64 payload, an int32 payload with
    NULLs, a row mask with dead padding rows, and NULL keys."""
    rng = np.random.default_rng(seed)
    if dense:
        k = rng.permutation(N).astype(np.int64) + 500
    else:
        k = rng.choice(10 ** 7, N, replace=False).astype(np.int64) - 77
    if dup:
        k[::7] = k[1::7][:len(k[::7])]
    mask = rng.random(N) < 0.9
    knull = (rng.random(N) < 0.05) if null_keys else np.zeros(N, bool)
    return {
        "k": (k.astype(key_dtype), knull),
        "k2": (rng.integers(0, 5, N).astype(np.int64), None),
        "f": (rng.normal(0, 1e6, N), None),
        "p": (rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32),
              rng.random(N) < 0.2),
    }, mask


def _batches(cols, mask):
    """The same batch in both packages."""
    jcols, tcols = {}, {}
    for name, (v, nl) in cols.items():
        jcols[name] = jb.Column(jnp.asarray(v),
                                None if nl is None else jnp.asarray(nl))
        tcols[name] = tb.Column(torch.from_numpy(v.copy()),
                                None if nl is None
                                else torch.from_numpy(nl.copy()))
    return (jb.Batch(jcols, jnp.asarray(mask)),
            tb.Batch(tcols, torch.from_numpy(mask.copy())))


def _probe_side(seed, build_keys):
    """Probe keys: half drawn from the build's keys, half around and
    beyond its range, with NULLs."""
    rng = np.random.default_rng(seed + 100)
    n = 4096
    k = rng.integers(-100, N + 900, n).astype(np.int64)
    k[:40] = rng.choice(10 ** 7, 40) - 77
    k[::2] = rng.choice(build_keys, n // 2)
    return {"k": (k, rng.random(n) < 0.08),
            "k2": (rng.integers(0, 5, n).astype(np.int64),
                   rng.random(n) < 0.03)}, rng.random(n) < 0.95


def test_orderable_hash_bits():
    rng = np.random.default_rng(3)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 5000,
                     dtype=np.int64, endpoint=True)
    want = np.asarray(jops._orderable_hash(jnp.asarray(x).view(jnp.uint64)))
    got = tops._orderable_hash(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # signed order of the flipped bits is the unsigned order of the hash
    np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                  np.argsort(x.view(np.uint64),
                                             kind="stable"))


@pytest.mark.parametrize("keys", [("k",), ("k", "k2")], ids=["one", "two"])
@pytest.mark.parametrize("dup", [False, True], ids=["unique", "dup"])
def test_build_table_bit_exact(keys, dup):
    jbatch, tbatch = _batches(*_build_side(1, dup=dup))
    want = jops.build_table(jbatch, list(keys))
    got = tops.build_table(tbatch, list(keys))
    for f in ("keyhash_sorted", "perm", "run_len", "valid_count"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert got.perm.dtype == torch.int32
    assert tfused._max_run(got) == int(jfused._max_run(want))


@pytest.mark.parametrize("case", ["dense", "int32", "sparse", "dup_join",
                                  "dup_semi", "float", "no_live"])
def test_try_direct_table(case):
    dtype = np.int32 if case == "int32" else np.int64
    cols, mask = _build_side(2, key_dtype=dtype, dense=case != "sparse",
                             dup=case.startswith("dup"))
    if case == "float":
        cols["k"] = (cols["k"][0].astype(np.float64), cols["k"][1])
    if case == "no_live":
        mask[:] = False
    jbatch, tbatch = _batches(cols, mask)
    jbatch = jfused._drop_null_keys(jbatch, ("k",))
    tbatch = tfused._drop_null_keys(tbatch, ("k",))
    allow_dup = case == "dup_semi"
    want = jfused.try_direct_table(jbatch, "k", allow_dup)
    got = tfused.try_direct_table(tbatch, "k", allow_dup)
    assert (got is None) == (want is None)
    if case in ("sparse", "dup_join", "float", "no_live"):
        assert got is None
        return
    assert int(got.base) == int(want.base)
    if case == "dup_semi":
        # a repeated key keeps one of its rows (which one is unspecified):
        # only a slot's existence is read
        np.testing.assert_array_equal(_np(got.slots) >= 0,
                                      np.asarray(want.slots) >= 0)
    else:
        np.testing.assert_array_equal(_np(got.slots), np.asarray(want.slots))
    jp, tp = _batches(*_probe_side(2, cols["k"][0]))
    jhit, jidx = jops.direct_lookup(jp, want, "k")
    thit, tidx = tops.direct_lookup(tp, got, "k")
    np.testing.assert_array_equal(_np(thit), np.asarray(jhit))
    assert bool(thit.any()) and not bool(thit.all())
    if case != "dup_semi":
        np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))


def test_null_key_flag_and_drop():
    jbatch, tbatch = _batches(*_build_side(4))
    assert tfused._build_has_null_key(tbatch, ("k",)) \
        == jfused._build_has_null_key(jbatch, ("k",)) is True
    assert tfused._build_has_null_key(tbatch, ("k2",)) is False
    np.testing.assert_array_equal(
        _np(tfused._drop_null_keys(tbatch, ("k", "p")).mask),
        np.asarray(jfused._drop_null_keys(jbatch, ("k", "p")).mask))


@pytest.mark.parametrize("bhn", [False, True], ids=["no_null", "null"])
@pytest.mark.parametrize("table", ["direct", "unique"])
def test_semi_marks(table, bhn):
    cols, mask = _build_side(5, dense=table == "direct")
    jbatch, tbatch = _batches(cols, mask)
    jbatch = jfused._drop_null_keys(jbatch, ("k",))
    tbatch = tfused._drop_null_keys(tbatch, ("k",))
    jp, tp = _batches(*_probe_side(5, cols["k"][0]))
    if table == "direct":
        jt = jfused.try_direct_table(jbatch, "k", True)
        tt = tfused.try_direct_table(tbatch, "k", True)
        want = jops.semi_join_mark_direct(jp, jt, "k", bhn)
        got = tops.semi_join_mark_direct(tp, tt, "k", bhn)
    else:
        want = jops.semi_join_mark(jp, jops.build_table(jbatch, ["k"]),
                                   ["k"], build_has_null=bhn)
        got = tops.semi_join_mark(tp, tops.build_table(tbatch, ["k"]),
                                  ["k"], build_has_null=bhn)
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))
    np.testing.assert_array_equal(_np(got.nulls), np.asarray(want.nulls))
    assert bool(got.values.any()) and bool(got.nulls.any())


def _step_arrays(jtbl, ttbl, kind, gcols, bhn):
    """The reference's and the port's flat operands of one probe step (the
    plan_join_layout order)."""
    if isinstance(ttbl, tfused.DirectTable):
        jarr = [jtbl.slots, jnp.asarray(jtbl.base, jnp.int64).reshape(1)]
        tarr = [ttbl.slots, ttbl.base]
    else:
        jarr = [jtbl.keyhash_sorted, jtbl.perm]
        tarr = [ttbl.keyhash_sorted, ttbl.perm]
    for n, has_nulls in gcols:
        jarr.append(jtbl.columns[n].values)
        tarr.append(ttbl.columns[n].values)
        if has_nulls:
            jarr.append(jtbl.columns[n].nulls)
            tarr.append(ttbl.columns[n].nulls)
    if kind == "semi":
        jarr.append(jnp.asarray(bhn, bool).reshape(1))
        tarr.append(torch.tensor([bhn]))
    return jarr, tarr


# (table, form): a semi step probes one key, so the two-key unique table
# is probed by joins only
APPLIER_CASES = [(t, f) for t in ("direct", "unique", "unique2")
                 for f in ("inner", "left", "semi")
                 if (t, f) != ("unique2", "semi")]


@pytest.mark.parametrize("table,form", APPLIER_CASES,
                         ids=[f"{t}-{f}" for t, f in APPLIER_CASES])
def test_appliers_match_reference(table, form):
    """Kernel #5's plain version: the torch applier of each table kind and
    form against the reference's _make_applier on the same operands."""
    keys = ("k", "k2") if table == "unique2" else ("k",)
    cols, mask = _build_side(6, dense=table == "direct")
    jbatch, tbatch = _batches(cols, mask)
    jbatch = jfused._drop_null_keys(jbatch, keys)
    tbatch = tfused._drop_null_keys(tbatch, keys)
    if table == "direct":
        jt = jfused.try_direct_table(jbatch, "k", form == "semi")
        tt = tfused.try_direct_table(tbatch, "k", form == "semi")
        assert tt is not None
    else:
        jt = jops.build_table(jbatch, list(keys))
        tt = tops.build_table(tbatch, list(keys))
    gcols = () if form == "semi" else (("f", False), ("p", True),
                                       ("k2", False))
    bhn = form == "semi"
    jarr, tarr = _step_arrays(jt, tt, form, gcols, bhn)
    args = (0, "semi" if form == "semi" else "join",
            "direct" if table == "direct" else "unique", form == "left",
            keys, "mark" if form == "semi" else "", gcols, len(tarr))
    want_fn = jjoin._make_applier(jjoin.JoinStepPlan(*args), jarr)
    got_fn = tjoin._make_applier(tjoin.JoinStepPlan(*args), tarr)
    pcols, pmask = _probe_side(6, cols["k"][0])
    if table == "unique2":
        # the second key equals the build row's for half the rows
        pos = {int(v): i for i, v in enumerate(cols["k"][0])}
        k2 = pcols["k2"][0].copy()
        for i in range(0, len(k2), 2):
            k2[i] = cols["k2"][0][pos[int(pcols["k"][0][i])]]
        pcols["k2"] = (k2, pcols["k2"][1])
    jp, tp = _batches(pcols, pmask)
    want, got = want_fn(jp), got_fn(tp)
    np.testing.assert_array_equal(_np(got.mask), np.asarray(want.mask))
    outs = ["mark"] if form == "semi" else [n for n, _ in gcols]
    for n in outs:
        w, g = want.columns[n], got.columns[n]
        np.testing.assert_array_equal(_np(g.values), np.asarray(w.values), n)
        assert (g.nulls is None) == (w.nulls is None), n
        if w.nulls is not None:
            np.testing.assert_array_equal(_np(g.nulls), np.asarray(w.nulls),
                                          n)
    hits = got.columns["mark"].values if form == "semi" else got.mask
    assert bool(hits.any()) and not bool(hits.all())
