"""The window kernel's host side on the CPU: the port's try_window_kernel
(its plain version, window_scan_plain) against the reference's
try_window_kernel (the Pallas kernel in interpret mode) on batches built
with numpy from a seed -- partition cardinalities 1, a few and n, order
keys with ties (ASC and DESC), NULL keys and arguments, a dictionary
key, a float64 key with NaNs and dead rows interleaved, every function
the kernel supports.  Live rows are equal bit for bit: every output is
int64 arithmetic.  Then the gates: WindowFunctionShape (float sum, an
explicit frame, lag) with the reference's reason, WindowInputSize (a
metered decline, then window_batch) through a memory context whose pool
is too small, and
kernelWindowPrograms."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import batch as jb
from presto_tpu.exec import operators as jops
from presto_tpu.exec.kernels import window as jwk
from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec.batch import Batch, Column
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.kernels import window as wk
from presto_tpu_torch.exec.memory import MemoryContext, MemoryPool
from presto_tpu_torch.utils.runtime_stats import RuntimeStats
from torch_threads import one_torch_thread  # noqa: F401

DICT = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


_FIELDS = [("row_number", "rn", None), ("rank", "rk", None),
           ("dense_rank", "dr", None), ("count_star", "c0", None),
           ("count", "cx", "x"), ("sum", "sx", "x"), ("avg", "ax", "x"),
           ("count", "cf", "f"), ("sum", "sy", "y"), ("avg", "ay", "y")]
# the edge structures' functions: ranks, a count and an avg over NULLs
_EDGE_FIELDS = [_FIELDS[i] for i in (1, 2, 4, 6)]


def _spec_sets(fields=_FIELDS):
    """(torch WindowSpec, JAX WindowSpec) tuples; by default every
    supported function, over an argument with NULLs and a NULL-free
    one."""
    return (tuple(ops.WindowSpec(n, o, a) for n, o, a in fields),
            tuple(jops.WindowSpec(n, o, a) for n, o, a in fields))


def _columns(seed: int, n: int, n_part: int):
    """numpy columns: p (partition key, NULLs), d (dictionary codes), o
    (order key with ties), f (float64 with NaNs and NULLs), x (decimal
    argument with NULLs), y (NULL-free argument), and the live mask with
    dead rows interleaved."""
    rng = np.random.default_rng(seed)
    return {
        "p": (rng.integers(0, n_part, n).astype(np.int64),
              rng.random(n) < 0.05),
        "d": (rng.integers(0, len(DICT), n).astype(np.int32), None),
        "o": (rng.integers(0, 6, n).astype(np.int32), None),
        "f": (np.where(rng.random(n) < 0.1, np.nan,
                       rng.integers(0, 8, n) / 2.0), rng.random(n) < 0.05),
        "x": (rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64),
              rng.random(n) < 0.15),
        "y": (rng.integers(0, 10 ** 6, n).astype(np.int64), None),
    }, rng.random(n) >= 0.2


def _batches(cols, live):
    tcols, jcols = {}, {}
    for name, (v, nl) in cols.items():
        dct = DICT if name == "d" else None
        tcols[name] = Column(torch.from_numpy(v),
                             None if nl is None else torch.from_numpy(nl),
                             dct)
        jcols[name] = jb.Column(jnp.asarray(v),
                                None if nl is None else jnp.asarray(nl), dct)
    return (Batch(tcols, torch.from_numpy(live)),
            jb.Batch(jcols, jnp.asarray(live)))


def _assert_live_equal(got, exp, names):
    mask = got.mask.numpy()
    assert np.array_equal(mask, np.asarray(exp.mask))
    for name in names:
        g, e = got.columns[name], exp.columns[name]
        gv, ev = g.values.numpy()[mask], np.asarray(e.values)[mask]
        if gv.dtype == np.float64:
            assert np.array_equal(gv.view(np.int64), ev.view(np.int64)), name
        else:
            assert np.array_equal(gv, ev), name
        none = np.zeros(int(mask.sum()), dtype=bool)
        gn = none if g.nulls is None else g.nulls.numpy()[mask]
        en = none if e.nulls is None else np.asarray(e.nulls)[mask]
        assert np.array_equal(gn, en), name


# the reference compiles one Pallas program per (keys, functions, padded
# width) and its sort per width: the cases share four programs and one
# width, and differ in their data
_BY_P = (("p",), (("o", "DESC_NULLS_LAST"), ("f", "ASC_NULLS_FIRST")))
_BY_DF = (("d", "f"), (("o", "ASC_NULLS_LAST"), ("y", "DESC_NULLS_LAST")))
# (seed, rows, partition cardinality, (partition keys, orderings), fields)
CASES = [
    (41, 1500, 40, _BY_P, _FIELDS),
    (42, 1500, 1, _BY_P, _FIELDS),
    (43, 1500, 1 << 40, _BY_P, _FIELDS),
    (44, 1500, 5, _BY_DF, _FIELDS),
    (46, 1500, 3, _BY_DF, _FIELDS),
    (45, 1500, 1, ((), (("o", "ASC_NULLS_LAST"),)), _EDGE_FIELDS),
    (47, 1500, 3, (("p",), ()), _EDGE_FIELDS),
]


@pytest.mark.parametrize("seed,n,n_part,keys,fields", CASES,
                         ids=[f"seed{c[0]}" for c in CASES])
def test_kernel_plain_matches_reference(seed, n, n_part, keys, fields):
    parts, orderings = keys
    cols, live = _columns(seed, n, n_part)
    tb, jbatch = _batches(cols, live)
    tspecs, jspecs = _spec_sets(fields)
    treasons, jreasons = [], []
    before = sk.LAUNCHES["window_scan"]
    got = wk.try_window_kernel(tb, parts, orderings, tspecs,
                               declined=treasons.append)
    exp = jwk.try_window_kernel(jbatch, parts, orderings, jspecs,
                                declined=jreasons.append)
    assert treasons == [] and jreasons == []
    # a CPU run is the plain version, not a launch
    assert sk.LAUNCHES["window_scan"] == before
    _assert_live_equal(got, exp, list(cols) + [s.output for s in tspecs])


def test_plain_version_equals_window_batch():
    """window_scan_plain and the path after a decline agree on every row
    the kernel computes (the parity contract of the two paths)."""
    cols, live = _columns(48, 2000, 30)
    tb, _ = _batches(cols, live)
    tspecs, _ = _spec_sets()
    orderings = (("o", "ASC_NULLS_LAST"), ("f", "DESC_NULLS_FIRST"))
    got = wk.try_window_kernel(tb, ("p",), orderings, tspecs,
                               declined=pytest.fail)
    exp = ops.window_batch(tb, ("p",), orderings, tspecs)
    mask = got.mask
    assert torch.equal(mask, exp.mask)
    for s in tspecs:
        g, e = got.columns[s.output], exp.columns[s.output]
        assert torch.equal(g.values[mask], e.values[mask]), s
        if g.nulls is not None:
            assert torch.equal(g.nulls[mask], e.nulls[mask]), s


def test_wrapper_raises_on_a_device_it_does_not_take():
    mask = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(NotImplementedError, match="window kernel on meta"):
        wk.window_scan(mask, {}, (), (), (ops.WindowSpec("row_number",
                                                         "rn"),))


def test_slots_share_one_prefix_sum_per_argument():
    specs = (ops.WindowSpec("count", "c", "x"), ops.WindowSpec("avg", "a",
                                                               "x"),
             ops.WindowSpec("count_star", "n"), ops.WindowSpec("rank", "r"))
    slots, of_spec = wk._slots(specs)
    assert slots == [("x", True), (None, False)]
    assert of_spec == [0, 0, 1, -1]


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    dict(name="sum", output="s", arg="x", is_float=True),
    dict(name="sum", output="s", arg="x",
         frame=("ROWS", "PRECEDING", 1, "CURRENT", None)),
    dict(name="lag", output="l", arg="x"),
    dict(name="count", output="c", arg="x", extra=(1,)),
], ids=["float_sum", "explicit_frame", "lag", "constant_extra"])
def test_function_shape_declines_like_reference(spec):
    cols, live = _columns(49, 64, 4)
    tb, jbatch = _batches(cols, live)
    treasons, jreasons = [], []
    assert wk.try_window_kernel(tb, ("p",), (("o", "ASC_NULLS_LAST"),),
                                (ops.WindowSpec(**spec),),
                                declined=treasons.append) is None
    assert jwk.try_window_kernel(jbatch, ("p",), (("o", "ASC_NULLS_LAST"),),
                                 (jops.WindowSpec(**spec),),
                                 declined=jreasons.append) is None
    assert treasons == jreasons == ["WindowFunctionShape"]


def test_input_size_declines_and_raises_when_the_reservation_fails():
    cols, live = _columns(50, 256, 4)
    tb, _ = _batches(cols, live)
    specs = (ops.WindowSpec("sum", "s", "x"),)
    # every column is gathered into the sorted run, not only the operands
    need = wk.window_bytes(256, {nm: (c.values, c.nulls)
                                 for nm, c in tb.columns.items()}, specs)
    assert need > wk.window_bytes(256, {nm: (tb.columns[nm].values,
                                             tb.columns[nm].nulls)
                                        for nm in ("p", "o", "x")}, specs)
    small = MemoryContext(MemoryPool(need - 1))
    reasons = []
    # the metered decline hands the node to ops.window_batch (None), as
    # the reference's pipeline does after every decline
    assert wk.try_window_kernel(tb, ("p",), (("o", "ASC_NULLS_LAST"),),
                                specs, declined=reasons.append,
                                pool=small) is None
    assert reasons == ["WindowInputSize"] and small.reserved == 0
    # a pool that holds the launch runs it and frees the reservation
    fits = MemoryContext(MemoryPool(need))
    assert wk.try_window_kernel(tb, ("p",), (("o", "ASC_NULLS_LAST"),),
                                specs, declined=reasons.append,
                                pool=fits) is not None
    assert fits.reserved == 0 and fits.peak == need
    assert reasons == ["WindowInputSize"]


def test_window_programs_metered():
    cols, live = _columns(51, 128, 4)
    tb, _ = _batches(cols, live)
    stats = RuntimeStats()
    before = sk.KERNEL_METRICS.snapshot()["window_programs"]
    wk.try_window_kernel(tb, ("p",), (("o", "ASC_NULLS_LAST"),),
                         (ops.WindowSpec("rank", "r"),),
                         declined=pytest.fail, runtime_stats=stats)
    assert stats.to_dict()["kernelWindowPrograms"]["sum"] == 1
    assert sk.KERNEL_METRICS.snapshot()["window_programs"] == before + 1
    assert "WindowFunctionShape" in sk.KERNEL_DECLINE_REASONS
    assert "WindowInputSize" in sk.KERNEL_DECLINE_REASONS
