"""The streaming join's probes, operators.probe_join and
probe_join_direct, against the reference's on seeded batches: INNER,
LEFT and FULL (LEFT with the `matched` vector, as the compiler runs a
FULL join), an ON filter over the pairs (NULL-able), NULL probe and build
keys, build keys repeated about 3 times a key (fanout > 1), and an output
overflow at a small join_out_capacity (the flag and the live total).
The live rows are compared after compaction (operators.compact), sorted;
everything is integer or a gathered float64, so exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import batch as jb
from presto_tpu.exec import fused as jfused
from presto_tpu.exec import operators as jops
from presto_tpu_torch.exec import batch as tb
from presto_tpu_torch.exec import fused as tfused
from presto_tpu_torch.exec import operators as tops
from torch_threads import one_torch_thread  # noqa: F401

NB, NP = 1500, 2048
OUT_NAMES = ("k", "pv", "bv", "bf")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _both(cols, mask):
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


def _sides(seed, dup):
    """(build batches, probe batches): a dense build key (repeated about
    3 times a key when `dup`) with NULLs, a NULL-able int payload and a float64
    payload; probe keys half drawn from the build's, half around it."""
    rng = np.random.default_rng(seed)
    bk = rng.permutation(NB).astype(np.int64) + 100
    if dup:
        # about 3 build rows a key, some keys 8 or more
        bk = rng.integers(100, 100 + NB // 3, NB).astype(np.int64)
    build = {"bk": (bk, rng.random(NB) < 0.04),
             "bv": (rng.integers(-50, 50, NB).astype(np.int64),
                    rng.random(NB) < 0.1),
             "bf": (rng.normal(0, 1e3, NB), None)}
    pk = rng.integers(0, NB + 300, NP).astype(np.int64)
    pk[::2] = rng.choice(bk, NP // 2)
    probe = {"k": (pk, rng.random(NP) < 0.05),
             "pv": (rng.integers(-50, 50, NP).astype(np.int64), None)}
    return (_both(build, rng.random(NB) < 0.9),
            _both(probe, rng.random(NP) < 0.93))


def _filter(pkg):
    """ON filter over the pairs: (pv + bv) % 3 != 0, NULL where bv is."""
    col = jb.Column if pkg == "jax" else tb.Column

    def fn(pairs):
        pv, bv = pairs.columns["pv"], pairs.columns["bv"]
        return col((pv.values + bv.values) % 3 != 0, bv.nulls)
    return fn


def _rows(batch):
    """The live rows of OUT_NAMES (None for NULL), sorted."""
    mask = _np(batch.mask)
    cols = []
    for n in OUT_NAMES:
        c = batch.columns[n]
        v = _np(c.values)
        nl = None if c.nulls is None else _np(c.nulls)
        cols.append([None if (nl is not None and nl[i]) else v[i].item()
                     for i in np.flatnonzero(mask)])
    return sorted(zip(*cols), key=repr)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("with_filter", [False, True],
                         ids=["no_filter", "on_filter"])
@pytest.mark.parametrize("jtype", ["INNER", "LEFT", "FULL"])
@pytest.mark.parametrize("dup", [False, True], ids=["unique", "fanout"])
def test_probe_join_matches_reference(seed, with_filter, jtype, dup):
    (jbuild, tbuild), (jprobe, tprobe) = _sides(seed, dup)
    jdrop = jfused._drop_null_keys(jbuild, ("bk",))
    tdrop = tfused._drop_null_keys(tbuild, ("bk",))
    jt = jops.build_table(jdrop, ["bk"])
    tt = tops.build_table(tdrop, ["bk"])
    full = jtype == "FULL"
    kind = "LEFT" if full else jtype
    jres = jops.probe_join(
        jprobe, jt, ["k"], ["bv", "bf"], 1 << 14, join_type=kind,
        filter_fn=_filter("jax") if with_filter else None,
        matched=jnp.zeros(NB, dtype=bool) if full else None)
    tres = tops.probe_join(
        tprobe, tt, ["k"], ["bv", "bf"], 1 << 14, join_type=kind,
        filter_fn=_filter("torch") if with_filter else None,
        matched=torch.zeros(NB, dtype=torch.bool) if full else None)
    assert not bool(jres[1]) and not bool(tres[1])
    assert int(jres[2]) == int(tres[2])
    got = tops.compact(tres[0])
    assert _rows(got) == _rows(jres[0])
    if not with_filter:
        # the total counts the pairs before the ON filter
        assert int(got.mask.sum()) == int(tres[2])
    if full:
        np.testing.assert_array_equal(_np(tres[3]), _np(jres[3]))
    # fanout > 1: build keys repeat
    assert (tfused._max_run(tt) > 1) == dup


@pytest.mark.parametrize("jtype", ["INNER", "LEFT"])
def test_probe_join_overflow_matches_reference(jtype):
    """A small output capacity overflows: the same flag and live total
    (the pairs' total, plus the null-extended rows for LEFT)."""
    (jbuild, tbuild), (jprobe, tprobe) = _sides(7, dup=True)
    jt = jops.build_table(jfused._drop_null_keys(jbuild, ("bk",)), ["bk"])
    tt = tops.build_table(tfused._drop_null_keys(tbuild, ("bk",)), ["bk"])
    jres = jops.probe_join(jprobe, jt, ["k"], ["bv", "bf"], 256,
                           join_type=jtype)
    tres = tops.probe_join(tprobe, tt, ["k"], ["bv", "bf"], 256,
                           join_type=jtype)
    assert bool(jres[1]) and bool(tres[1])
    assert int(jres[2]) == int(tres[2]) > 256


@pytest.mark.parametrize("with_filter", [False, True],
                         ids=["no_filter", "on_filter"])
@pytest.mark.parametrize("jtype", ["INNER", "LEFT", "FULL"])
def test_probe_join_direct_matches_reference(jtype, with_filter):
    (jbuild, tbuild), (jprobe, tprobe) = _sides(3, dup=False)
    jdt = jfused.try_direct_table(jfused._drop_null_keys(jbuild, ("bk",)),
                                  "bk", allow_dup=False)
    tdt = tfused.try_direct_table(tfused._drop_null_keys(tbuild, ("bk",)),
                                  "bk", allow_dup=False)
    assert jdt is not None and tdt is not None
    full = jtype == "FULL"
    kind = "LEFT" if full else jtype
    jout, jm = jops.probe_join_direct(
        jprobe, jdt, "k", ["bv", "bf"], join_type=kind,
        filter_fn=_filter("jax") if with_filter else None,
        matched=jnp.zeros(NB, dtype=bool) if full else None)
    tout, tm = tops.probe_join_direct(
        tprobe, tdt, "k", ["bv", "bf"], join_type=kind,
        filter_fn=_filter("torch") if with_filter else None,
        matched=torch.zeros(NB, dtype=torch.bool) if full else None)
    assert _rows(tops.compact(tout)) == _rows(jout)
    if full:
        np.testing.assert_array_equal(_np(tm), _np(jm))


def test_null_keys_never_match():
    """NULL probe keys pair with nothing, NULL build keys are dropped
    before the build: the INNER output holds no NULL key."""
    (_jb, tbuild), (_jp, tprobe) = _sides(5, dup=False)
    tt = tops.build_table(tfused._drop_null_keys(tbuild, ("bk",)), ["bk"])
    out, _ov, total, _m = tops.probe_join(tprobe, tt, ["k"], ["bv", "bf"],
                                          1 << 14)
    live = _np(out.mask)
    assert not _np(out.columns["k"].null_mask())[live].any()
    assert int(total) == int(live.sum()) > 0
