"""The grouped kernels' plain versions (presto_tpu_torch exec/kernels/
grouped.py try_grouped_scan_kernel: span and hash modes) against the
reference Pallas kernels (interpret mode on the CPU) on the same encoded
state: synthetic columns in every encoding -- the open hash key plain,
dictionary-coded or run-length -- built by the reference encoder and
carried across with resident_from_numpy.

The finalized groups are compared keyed by their key values (the hash
tables' slot layouts differ by design): keys, counts and integer
aggregates exactly, float64 aggregates within rtol 1e-12 (another
summation order)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.exec import memory as jmem
from presto_tpu.exec import operators as jops
from presto_tpu.exec import pipeline as jpipe
from presto_tpu.exec.kernels import grouped as jgk
from presto_tpu.exec.lowering import Lowering as JLowering, _jnp_dtype
from presto_tpu.storage import encodings as jenc
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.exec import memory as tmem
from presto_tpu_torch.exec import operators as tops
from presto_tpu_torch.exec import pipeline as tpipe
from presto_tpu_torch.exec.kernels import grouped as tgk
from presto_tpu_torch.exec.kernels import scan_kernel as tsk
from presto_tpu_torch.exec.lowering import param_vector
from presto_tpu_torch.storage.encodings import resident_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

N_ROWS = 12000
CAP = 4096
ZONE = 1024
PARAMS = [9200]                          # a date
K3 = tuple(f"m{i:02d}" for i in range(40))
DICTS = {"k1": ("A", "N", "R"), "k2": ("F", "O"), "k3": K3}
SPLITS = [(0, 5000), (5600, N_ROWS - 3)]


def _schema(T):
    return {"v": T.BIGINT, "q": T.DecimalType(12, 2), "dt": T.DATE,
            "f": T.DOUBLE, "k1": T.VarcharType(1), "k2": T.VarcharType(1),
            "k3": T.VarcharType(3)}


def _columns(enc: str):
    rng = np.random.default_rng(11)
    n = N_ROWS
    if enc == "rle":
        v = np.repeat(rng.integers(-900, 900, n // 30 + 1), 30)[:n]
    elif enc == "dict":
        v = rng.integers(0, 90, n) * 1000 - 7
    else:
        v = rng.integers(-10 ** 12, 10 ** 12, n) % 700 * 1234567
    raw = {
        "v": (v.astype(np.int64), {"plain": "plain", "rle": "rle"}.get(enc)),
        "q": (rng.integers(1, 51, n).astype(np.int64) * 100, None),
        "dt": (np.sort(rng.integers(8000, 10000, n)).astype(np.int32),
               "plain"),
        "f": (np.round(rng.normal(100, 50, n), 3), "plain"),
        "k1": (rng.integers(0, 3, n).astype(np.int32), None),
        "k2": (rng.integers(0, 2, n).astype(np.int32), None),
        "k3": (rng.integers(0, 40, n).astype(np.int32), None),
    }
    out = {}
    for name, (body, hint) in raw.items():
        arr = np.concatenate([body, np.zeros(CAP, dtype=body.dtype)])
        col = jenc.encode_column(jnp.asarray(arr), n, hint=hint)
        out[name] = (col, jenc.build_zone_maps(jnp.asarray(arr), n, ZONE))
    assert out["v"][0].kind == enc
    return out


def _chain_parts(E, T):
    """(steps, aggregate inputs) for one package: a date filter on a
    bound parameter, then a projected decimal product."""
    s = _schema(T)
    var = {n: E.variable(n, t) for n, t in s.items()}
    B, D = T.BOOLEAN, T.DecimalType
    disc = E.variable("disc", D(24, 2))
    steps = [("filter", E.call("gte", B, var["dt"],
                               E.BoundParameterExpression(0, T.DATE))),
             ("project", [(disc, E.call("multiply", D(24, 2), var["q"],
                                        var["q"]))]
              + [(var[n], var[n]) for n in s if n != "dt"])]
    return steps, {"sum_q": var["q"], "avg_q": var["q"], "cnt": None,
                   "cnt_v": var["v"], "min_v": var["v"], "max_q": var["q"],
                   "sum_disc": disc, "sum_f": var["f"], "max_f": var["f"]}


def _specs(ops):
    S = ops.AggSpec
    return (S("sum", "sum_q"), S("avg", "avg_q"), S("count_star", "cnt"),
            S("count", "cnt_v"), S("min", "min_v"), S("max", "max_q"),
            S("sum", "sum_disc"), S("sum", "sum_f", True),
            S("max", "max_f", True))


def _meta(zones, types):
    return {"dicts": dict(DICTS), "colmap": {n: n for n in _schema(JT)},
            "splits": [SimpleNamespace(start=s, end=e) for s, e in SPLITS],
            "cap": CAP, "zone_maps": zones,
            "pushdown": [{"column": "dt", "op": "gte",
                          "value": ["param", 0]}],
            "types": types}


def _groups(batch, key_names, specs, to_np):
    """{key tuple: (exact values, float values)} over the live rows."""
    live = to_np(batch.mask).astype(bool)
    cols = {}
    for name, c in batch.columns.items():
        v = to_np(c.values)[live]
        nl = (np.zeros(v.shape, bool) if c.nulls is None
              else to_np(c.nulls)[live].astype(bool))
        cols[name] = [None if n else x for x, n in zip(v.tolist(),
                                                        nl.tolist())]
    out = {}
    for i in range(int(live.sum())):
        key = tuple(cols[k][i] for k in key_names)
        exact = tuple(cols[s.output][i] for s in specs if not s.is_float)
        flt = tuple(cols[s.output][i] for s in specs if s.is_float)
        out[key] = (exact, flt)
    return out


def _run_both(enc: str, key_names, span: bool):
    cols = _columns(enc)
    zones = {n: z for n, (_c, z) in cols.items()}
    jcached = {n: c for n, (c, _z) in cols.items()}
    jkdts = tuple(np.asarray(jcached[k].decode_full()).dtype
                  for k in key_names)
    kdicts = {k: DICTS[k] for k in key_names if k in DICTS}
    span_info = None
    if span:
        doms = tuple(len(DICTS[k]) for k in key_names)
        strides = tuple(int(np.prod(doms[i + 1:]))
                        for i in range(len(doms)))
        span_info = (doms, int(np.prod(doms)), strides)

    # -- reference: the Pallas grouped kernel in interpret mode ---------
    steps, agg_in = _chain_parts(JE, JT)
    jchain = SimpleNamespace(
        steps=steps, scan_meta=_meta(zones, None), has_params=True,
        leaf_cap=lambda _e: CAP,
        compiler=SimpleNamespace(ctx=SimpleNamespace(
            params_fingerprint=tuple(PARAMS))))
    jparams = tuple(jnp.asarray(v, dtype=_jnp_dtype(JT.DATE))
                    for v in PARAMS)
    low = JLowering()
    jres = jgk.try_grouped_scan_kernel(
        jchain, (jcached, jparams), specs=_specs(jops), key_names=key_names,
        key_dtypes=jkdts, key_dicts=kdicts, key_lazy={},
        span_info=(span_info + (jkdts, kdicts) if span else None),
        est_slots=1024,
        agg_exprs=lambda b: {o: (None if e is None else low.eval(e, b))
                             for o, e in agg_in.items()},
        lowering=low, cache={}, declined=lambda r: pytest.fail(r),
        pool=jmem.MemoryPool(None), state_bytes=jpipe._agg_state_bytes)
    assert jres is not None
    jout, jcounts, jblocks = jres

    # -- port: the plain version on the same encoded state --------------
    tout, tcounts, tblocks = _port_run(
        enc, key_names, span, tmem.MemoryContext(tmem.MemoryPool(None)),
        cols)
    assert tblocks == jblocks
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    return (_groups(tout, key_names, _specs(tops), lambda t: t.numpy()),
            _groups(jout, key_names, _specs(jops), np.asarray))


def _port_run(enc: str, key_names, span: bool, pool, cols=None):
    """The port's try_grouped_scan_kernel (plain versions on the CPU) over
    _columns(enc): (finalized Batch, row counters, grid length)."""
    cols = _columns(enc) if cols is None else cols
    kdicts = {k: DICTS[k] for k in key_names if k in DICTS}
    steps, agg_in = _chain_parts(TE, TT)
    tcached, tzones = {}, {}
    for n, (c, z) in cols.items():
        tcached[n], tzones[n] = resident_from_numpy(
            c.kind, [np.asarray(a) for a in c.arrays], z, c.n_rows)
    meta = _meta(tzones, _schema(TT))
    meta["cached_cols"] = tcached
    tchain = SimpleNamespace(
        steps=steps, scan_meta=meta, leaf_cap=lambda _e: CAP,
        compiler=SimpleNamespace(ctx=SimpleNamespace(
            params_fingerprint=tuple(PARAMS))))
    tkdts = tuple(tcached[k].dtype for k in key_names)
    span_info = None
    if span:
        doms = tuple(len(DICTS[k]) for k in key_names)
        strides = tuple(int(np.prod(doms[i + 1:]))
                        for i in range(len(doms)))
        span_info = (doms, int(np.prod(doms)), strides, tkdts, kdicts)
    tres = tgk.try_grouped_scan_kernel(
        tchain, param_vector(PARAMS, [TT.DATE], "cpu"), specs=_specs(tops),
        key_names=key_names, key_dtypes=tkdts, key_dicts=kdicts,
        span_info=span_info, est_slots=1024, agg_inputs=agg_in, cache={},
        declined=lambda r: pytest.fail(r), pool=pool,
        state_bytes=tpipe._agg_state_bytes)
    assert tres is not None
    return tres


def _assert_groups_equal(got, want):
    assert got.keys() == want.keys()
    for key, (exact, flt) in want.items():
        assert got[key][0] == exact, key
        np.testing.assert_allclose(got[key][1], flt, rtol=1e-12, err_msg=key)


@pytest.mark.parametrize("enc", ["plain", "dict", "rle"])
def test_hash_mode_matches_pallas_kernel(enc):
    got, want = _run_both(enc, ("v", "k1"), span=False)
    assert len(want) > 64
    _assert_groups_equal(got, want)


@pytest.mark.parametrize("keys", [("k1", "k2", "k3"), ("k3", "k1")],
                         ids=["k1_k2_k3", "k3_k1"])
def test_span_mode_matches_pallas_kernel(keys):
    got, want = _run_both("dict", keys, span=True)
    assert len(want) > 64
    _assert_groups_equal(got, want)


def _layout_plan(mode, src_rows, n_f, smem_bytes, onchip_slots,
                 ring_reserve=0):
    """A ScanPlan carrying only the fields the launch geometry reads."""
    n_i = len(src_rows)
    return tsk.ScanPlan(
        mode, (), 0, [], [], (), 0, (), {},
        tuple(f"i{k}" for k in range(n_i)), tuple(f"f{k}" for k in range(n_f)),
        torch.zeros(n_i, dtype=torch.int64), torch.zeros(n_f),
        np.zeros(0, dtype=np.int64), 256, smem_bytes, tuple(src_rows),
        onchip_slots, ring_reserve)


def test_partial_bytes_follow_the_launch_grid(monkeypatch):
    """The bytes try_grouped_scan_kernel reserves for a launch's partials:
    on chip, each CTA's folded integer rows and float rows (the generated
    span kernel: a float table per warp where those fit), over as many
    CTAs per SM (at most RESIDENT_THREADS of threads) as the tables leave
    room for; on the device-memory path, per-warp float rows over
    RESIDENT_THREADS / threads CTAs per SM, fewer when they would pass
    FLOAT_PARTIAL_BYTES; none on the CPU."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: SimpleNamespace(multi_processor_count=132))
    card = SimpleNamespace(type="cuda")
    # three integer rows, the third a count copied from __seen: two folded
    span = _layout_plan("span", (0, 1, 0), 2, 50000, 1000)
    assert span.n_fold == 2 and span.layout(168).on_chip
    assert span.layout(168).ctas_per_sm == 2
    # 10 entries of 65536 rows: 80 slices of 8192 rows, one CTA each;
    # 168 slots hold the two float rows once per warp (8 warps)
    assert span.layout(168).warp_floats and span.layout(168).f_tables == 8
    assert tgk.partial_bytes(span, 10, 65536, 168, card) \
        == 8 * 80 * (2 + 2 * 8) * 168
    hash_plan = _layout_plan("hash", (0, 1), 4, 50000, 0)
    # 2 * 132 CTAs would hold 264 * 8 * 4 * 65536 * 8 bytes: capped at 32
    assert tgk.partial_bytes(hash_plan, 1000, 65536, 65536, card) \
        == tgk.FLOAT_PARTIAL_BYTES == 8 * 32 * 8 * 4 * 65536
    ints_only = _layout_plan("hash", (0, 1), 0, 50000, 0)
    assert tgk.partial_bytes(ints_only, 1000, 65536, 4096, card) == 0
    # a table too large for two CTAs' shared memory: one CTA per SM
    big = _layout_plan("hash", (0, 1, 0, 0), 1, 100000, 4096, 10000)
    assert big.layout(4096).table_bytes == 8 * 4096 * (2 + 1 + 1)
    assert big.layout(4096).ctas_per_sm == 1
    assert tgk.partial_bytes(big, 1000, 65536, 4096, card) \
        == 8 * 132 * (2 + 1) * 4096
    # past onchip_slots the launch takes the device-memory path
    assert not big.layout(8192).on_chip and big.layout(8192).table_bytes == 0
    assert tgk.partial_bytes(big, 1000, 65536, 8192, card) \
        == 8 * 264 * 8 * 1 * 8192
    assert tgk.partial_bytes(span, 10, 65536, 168,
                             torch.device("cpu")) == 0
    assert tgk.partial_bytes(span, 0, 65536, 168, card) == 0


@pytest.mark.parametrize("span", [True, False], ids=["span", "hash"])
def test_reservation_covers_the_partials(monkeypatch, span):
    """Each grouped launch reserves its partials with its state and frees
    both after it."""
    monkeypatch.setattr(tgk, "partial_bytes",
                        lambda plan, n_grid, br, G, device: 1000 + G)
    pool = tmem.MemoryContext(tmem.MemoryPool(None))
    seen = []
    real = pool.try_reserve

    def recording(n):
        seen.append(n)
        return real(n)
    monkeypatch.setattr(pool, "try_reserve", recording)
    _port_run("dict", ("k1", "k2", "k3") if span else ("v", "k1"), span,
              pool)
    n_specs = len(_specs(tops))
    if span:
        assert seen == [3 * 2 * 40 * 24 * n_specs + 1000 + 240]
    else:
        assert seen == [tpipe._agg_state_bytes(1024, ("v", "k1"),
                                               _specs(tops)) + 1000 + 1024]
    assert pool.reserved == 0
