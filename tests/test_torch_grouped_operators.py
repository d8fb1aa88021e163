"""Grouped-aggregation operators of the port against the reference
package on the same numpy-seeded inputs: key hashing (bit-exact, keyhash
compared as the int64 view of the uint64), the hashed open-addressing
table (agg_init / agg_update, state entry by entry, collisions included),
and span aggregation (agg_span_update / agg_span_finalize)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import batch as jbatch
from presto_tpu.exec import operators as jops
from presto_tpu_torch.exec import batch as tbatch
from presto_tpu_torch.exec import operators as tops
from torch_threads import one_torch_thread  # noqa: F401

I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)
N = 600


def _key_values(kind: str, rng):
    """Random values of one key dtype with its edge values first."""
    if kind == "int64":
        edges = [0, -1, 1, I64.min, I64.max, I64.min + 1, 1 << 40]
        body = rng.integers(I64.min, I64.max, N, dtype=np.int64)
        return np.concatenate([edges, body]).astype(np.int64)[:N]
    if kind == "int32":
        edges = [0, -1, 1, I32.min, I32.max]
        body = rng.integers(I32.min, I32.max, N, dtype=np.int32)
        return np.concatenate([edges, body]).astype(np.int32)[:N]
    if kind == "dict_code":
        return rng.integers(0, 7, N).astype(np.int8)
    if kind == "bool":
        return rng.random(N) < 0.5
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e308, 5e-324, -2.5]
    body = rng.normal(0, 1e6, N)
    return np.concatenate([edges, body])[:N]


def _cols(values, nulls):
    jc = [jbatch.Column(jnp.asarray(v), None if n is None else jnp.asarray(n))
          for v, n in zip(values, nulls)]
    tc = [tbatch.Column(torch.from_numpy(np.array(v)),
                        None if n is None else torch.from_numpy(np.array(n)))
          for v, n in zip(values, nulls)]
    return jc, tc


KINDS = ["int64", "int32", "dict_code", "bool", "float64"]


@pytest.mark.parametrize("salt", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_hash_columns_bit_exact(kind, salt):
    rng = np.random.default_rng(KINDS.index(kind) + 10 * salt)
    values = [_key_values(kind, rng)]
    for nulls in (None, rng.random(N) < 0.2):
        jc, tc = _cols(values, [nulls])
        want = np.asarray(jops.hash_columns(jc, salt)).view(np.int64)
        got = tops.hash_columns(tc, salt).numpy()
        np.testing.assert_array_equal(got, want)


def test_hash_columns_multi_key_bit_exact():
    rng = np.random.default_rng(1)
    values = [_key_values(k, rng) for k in KINDS]
    nulls = [None, rng.random(N) < 0.3, None, None, rng.random(N) < 0.1]
    jc, tc = _cols(values, nulls)
    for salt in (0, 1, 6):
        want = np.asarray(jops.hash_columns(jc, salt)).view(np.int64)
        np.testing.assert_array_equal(tops.hash_columns(tc, salt).numpy(),
                                      want)


def _specs(ops):
    S = ops.AggSpec
    return (S("count_star", "cs"), S("count", "ci"), S("sum", "si"),
            S("avg", "ai"), S("min", "mi"), S("max", "xi"),
            S("sum", "sf", True), S("min", "mf", True), S("max", "xf", True))


def _agg_inputs(d, make):
    i = make(d["i"], d["i_nulls"])
    f = make(d["f"], d["f_nulls"])
    return {"cs": None, "ci": i, "si": i, "ai": i, "mi": i, "xi": i,
            "sf": f, "mf": f, "xf": f}


def _batch_data(seed: int, n_keys: int):
    rng = np.random.default_rng(seed)
    return {
        "k0": rng.integers(0, n_keys, N).astype(np.int64) * 7919 - 50,
        "k1": rng.integers(0, 3, N).astype(np.int32),
        "k1_nulls": rng.random(N) < 0.1,
        "mask": rng.random(N) < 0.85,
        "i": rng.integers(-10 ** 9, 10 ** 9, N).astype(np.int64),
        "i_nulls": rng.random(N) < 0.2,
        "f": np.round(rng.normal(0, 1e3, N), 2),
        "f_nulls": rng.random(N) < 0.2,
    }


def _jcol(v, n):
    return jbatch.Column(jnp.asarray(v), None if n is None else jnp.asarray(n))


def _tcol(v, n):
    return tbatch.Column(torch.from_numpy(v.copy()),
                         None if n is None else torch.from_numpy(n.copy()))


def _assert_states_equal(tst, jst):
    assert set(tst) == set(jst)
    for k, jv in jst.items():
        want = np.asarray(jv)
        got = tst[k].numpy()
        if want.dtype == np.uint64:
            want = want.view(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("num_slots,n_keys,salt,collides", [
    (256, 40, 0, False), (256, 40, 2, False), (64, 12, 1, None),
    (8, 50, 0, True)], ids=["roomy", "salted", "crowded", "collision"])
def test_agg_update_state_bit_exact(num_slots, n_keys, salt, collides):
    """Two batches through agg_update on both sides: every state entry
    (keyhash, occupancy, collision, key values and nulls, accumulators)
    is identical, slot for slot."""
    jspecs, tspecs = _specs(jops), _specs(tops)
    names = ("k0", "k1")
    jst = jops.agg_init(num_slots, jspecs, names, (jnp.int64, jnp.int32))
    tst = tops.agg_init(num_slots, tspecs, names, (torch.int64, torch.int32),
                        "cpu")
    _assert_states_equal(tst, jst)
    for seed in (n_keys, n_keys + 1):
        d = _batch_data(seed, n_keys)
        jkeys = [_jcol(d["k0"], None), _jcol(d["k1"], d["k1_nulls"])]
        tkeys = [_tcol(d["k0"], None), _tcol(d["k1"], d["k1_nulls"])]
        jst = jops.agg_update(jst, jbatch.Batch({}, jnp.asarray(d["mask"])),
                              jkeys, _agg_inputs(d, _jcol), jspecs,
                              num_slots, salt, names)
        tst = tops.agg_update(tst, tbatch.Batch(
            {}, torch.from_numpy(d["mask"].copy())), tkeys,
            _agg_inputs(d, _tcol), tspecs, num_slots, salt, names)
    _assert_states_equal(tst, jst)
    if collides is not None:
        assert bool(tst["__collision"]) == collides
    jout = jops.agg_finalize(jst, jspecs, names, {})
    tout = tops.agg_finalize(tst, tspecs, names, {})
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    for name, jc in jout.columns.items():
        tc = tout.columns[name]
        np.testing.assert_array_equal(tc.null_mask().numpy(),
                                      np.asarray(jc.null_mask()), err_msg=name)
        live = ~np.asarray(jc.null_mask())
        np.testing.assert_array_equal(tc.values.numpy()[live],
                                      np.asarray(jc.values)[live],
                                      err_msg=name)


@pytest.mark.parametrize("G", [65, 1000, 21504])
def test_span_update_and_finalize_match_reference(G):
    rng = np.random.default_rng(G)
    jspecs, tspecs = _specs(jops), _specs(tops)
    jst = jops.agg_span_init(G, jspecs)
    tst = tops.agg_span_init(G, tspecs, "cpu")
    for half in range(2):
        d = _batch_data(G + half, 5)
        codes = rng.integers(0, G, N).astype(np.int64)
        jst = jops.agg_span_update(
            jst, jbatch.Batch({}, jnp.asarray(d["mask"])), jnp.asarray(codes),
            _agg_inputs(d, _jcol), jspecs, G)
        tst = tops.agg_span_update(
            tst, tbatch.Batch({}, torch.from_numpy(d["mask"].copy())),
            torch.from_numpy(codes), _agg_inputs(d, _tcol), tspecs, G)
    assert list(tst) == list(jst)
    for k in jst:
        want, got = np.asarray(jst[k]), tst[k].numpy()
        if want.dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    # two keys: a 3-code dictionary key and the rest of the span
    doms = (3, -(-G // 3))
    slot = np.arange(G, dtype=np.int64)
    keys = {"a": (slot // doms[1]) % doms[0], "b": slot % doms[1]}
    jout = jops.agg_span_finalize(
        jst, jspecs, ("a", "b"), {k: jnp.asarray(v) for k, v in keys.items()},
        {"a": ("x", "y", "z")})
    tout = tops.agg_span_finalize(
        tst, tspecs, ("a", "b"), {k: torch.from_numpy(v)
                                  for k, v in keys.items()},
        {"a": ("x", "y", "z")})
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    assert tout.columns["a"].dictionary == jout.columns["a"].dictionary
    for name, jc in jout.columns.items():
        tc = tout.columns[name]
        live = np.asarray(jout.mask) & ~np.asarray(jc.null_mask())
        np.testing.assert_array_equal(tc.null_mask().numpy()[live], False)
        jv, tv = np.asarray(jc.values)[live], tc.values.numpy()[live]
        if jv.dtype == np.float64:
            np.testing.assert_allclose(tv, jv, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=name)


def test_key_bits_match_the_reference_hash_input():
    """key_bits is what hash_columns mixes: hashing the bits as plain
    int64 gives the same hash as hashing the typed column."""
    rng = np.random.default_rng(3)
    for kind in KINDS:
        v = _key_values(kind, rng)
        col = tbatch.Column(torch.from_numpy(np.array(v)))
        bits = tbatch.Column(tops.key_bits(col))
        assert bits.values.dtype == torch.int64
        np.testing.assert_array_equal(tops.hash_columns([bits], 1).numpy(),
                                      tops.hash_columns([col], 1).numpy())
