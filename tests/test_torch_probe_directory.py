"""Kernel #5's unique-table probe through the bucket directory, on the CPU.

The kernels look a probe hash up in a unique table (ops.BuildTable) through
its bucket directory (exec/kernels/join.py bucket_directory): one load of
the hash's bucket bounds, then a bisect inside the bucket
(csrc/scan_common.cuh probe_unique).  A torch model of that lookup, written
here step for step as the kernel runs it, must give
torch.searchsorted(side="left")'s index -- by construction, for every
hash -- and the plain probe's (hit, build row): for tables of 1 to 65536
entries, duplicate hashes, thousands of dead padding rows (INT64_MAX),
probe hashes at 0, INT64_MIN, INT64_MAX and at the edges of every bucket,
and NULL keys.  The reference's own applier (presto_tpu/exec/kernels/
join.py _make_applier, the two-column unique probe of the PARTSUPP shape)
runs under JAX on the same numpy inputs and gives the same hits and rows.
The CUDA function itself runs only on the card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu.exec import batch as jbatch
from presto_tpu.exec import operators as jops
from presto_tpu.exec.kernels import join as jjoin
from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec.batch import Batch, Column
from presto_tpu_torch.exec.kernels import join as tjoin
from torch_threads import one_torch_thread  # noqa: F401

INT64_MIN, INT64_MAX = ops.INT64_MIN, ops.INT64_MAX


def _bucket(khs, directory, kh):
    """Each hash's bucket bounds (D[b], D[b + 1]): b = the unsigned hash's
    top k bits (the orderable hash shifted arithmetically, plus
    2^(k-1))."""
    k = tjoin.directory_bits(int(khs.numel()))
    b = (kh >> (64 - k)) + (1 << (k - 1))
    d = directory.long()
    return d[b], d[b + 1]


def directory_lookup(khs, directory, kh):
    """The kernel's lookup of orderable hashes `kh`: lo, hi = the bucket's
    bounds, then the rows' bisect inside [lo, hi) until every row's range
    is empty.  Returns (lower bound, trips of the longest bisect)."""
    n = int(khs.numel())
    lo, hi = _bucket(khs, directory, kh)
    trips = 0
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = khs[mid.clamp(max=max(n - 1, 0))]
        below = active & (v < kh)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
        trips += 1
    return lo, trips


def directory_probe(table, kh, knull):
    """The kernel's (hit, build row) after the lookup: the reference's
    clip to [0, n - 1], an equal hash with no NULL key, perm[lo]; a hash
    whose bucket is empty is a miss without the compare."""
    khs, d = table.keyhash_sorted, table.directory
    lo, _trips = directory_lookup(khs, d, kh)
    b_lo, b_hi = _bucket(khs, d, kh)
    p = lo.clamp(0, table.perm.shape[0] - 1)
    hit = (b_lo < b_hi) & (khs[p] == kh) & ~knull
    return hit, torch.where(hit, table.perm[p].long(), torch.zeros_like(p))


def _table(keys, live=None):
    """A unique table over int64 key columns (live rows; dead rows pad
    the sorted hashes with INT64_MAX) with its directory."""
    cols = {f"k{j}": Column(torch.from_numpy(k)) for j, k in enumerate(keys)}
    n = len(keys[0])
    mask = torch.ones(n, dtype=torch.bool) if live is None \
        else torch.from_numpy(live)
    tbl = ops.build_table(Batch(cols, mask), list(cols))
    tbl.directory = tjoin.bucket_directory(tbl.keyhash_sorted)
    return tbl


def _plain_probe(tbl, probe_keys, nulls=None):
    """The port's plain probe (join._make_applier, an INNER join that
    gathers the build row index): (hit, build row)."""
    names = tuple(f"k{j}" for j in range(len(probe_keys)))
    n_build = tbl.perm.shape[0]
    rowid = torch.arange(n_build, dtype=torch.int64)
    sp = tjoin.JoinStepPlan(0, "join", "unique", False, names, "",
                            (("rowid", False),), 3)
    applier = tjoin._make_applier(sp, (tbl.keyhash_sorted, tbl.perm, rowid))
    cols = {}
    for j, (name, v) in enumerate(zip(names, probe_keys)):
        nl = None if nulls is None or nulls[j] is None \
            else torch.from_numpy(nulls[j])
        cols[name] = Column(torch.from_numpy(v), nl)
    n = len(probe_keys[0])
    out = applier(Batch(cols, torch.ones(n, dtype=torch.bool)))
    hit = out.mask
    return hit, torch.where(hit, out.columns["rowid"].values,
                            torch.zeros_like(out.columns["rowid"].values))


def _probe_hashes(tbl, probe_keys, nulls=None):
    cols = [Column(torch.from_numpy(v),
                   None if nulls is None or nulls[j] is None
                   else torch.from_numpy(nulls[j]))
            for j, v in enumerate(probe_keys)]
    knull = torch.zeros(len(probe_keys[0]), dtype=torch.bool)
    for c in cols:
        if c.nulls is not None:
            knull |= c.nulls
    return ops._orderable_hash(ops.hash_columns(cols)), knull


def _edge_hashes(tbl):
    """0, INT64_MIN, INT64_MAX, every bucket's first and last hash and
    their neighbours, every table hash and its neighbours."""
    khs = tbl.keyhash_sorted
    k = tjoin.directory_bits(int(khs.numel()))
    starts = [(b - (1 << (k - 1))) << (64 - k) for b in range(1 << k)]
    vals = {0, INT64_MIN, INT64_MAX, INT64_MIN + 1, INT64_MAX - 1, -1, 1}
    # every bucket's edges up to 2^14 buckets, else every 16th and the
    # last 64
    step = 1 if len(starts) <= 1 << 14 else 16
    for s in starts[::step] + starts[-64:]:
        vals.update({s, s - 1, s + 1})
    for h in khs[:4096].tolist() + khs[-64:].tolist():
        vals.update({h, h - 1, h + 1})
    vals = [v for v in vals if INT64_MIN <= v <= INT64_MAX]
    return torch.tensor(sorted(vals), dtype=torch.int64)


@pytest.mark.parametrize("n", [1, 2, 4000, 65536])
def test_directory_gives_the_searchsorted_index(n):
    rng = np.random.default_rng(n)
    tbl = _table([rng.integers(-10 ** 12, 10 ** 12, n)])
    k = tjoin.directory_bits(n)
    d = tbl.directory
    assert d.dtype == torch.int32 and d.numel() == (1 << k) + 1
    assert int(d[-1]) == n and bool((d[1:] >= d[:-1]).all())
    assert (1 << k) > 2 * n
    kh = _edge_hashes(tbl)
    got, trips = directory_lookup(tbl.keyhash_sorted, d, kh)
    want = torch.searchsorted(tbl.keyhash_sorted, kh, side="left")
    assert torch.equal(got, want)
    # the hit rule, the empty buckets' shortcut included, is the
    # reference's clipped compare on every edge hash
    hit, _row = directory_probe(tbl, kh, torch.zeros_like(kh, dtype=bool))
    assert torch.equal(hit, tbl.keyhash_sorted[want.clamp(0, n - 1)] == kh)
    # buckets of 0-2 entries on average: a bisect of a few trips
    assert trips <= 8
    # the probe over random keys, half of them in the table
    keys = np.concatenate([rng.integers(-10 ** 12, 10 ** 12, 3000),
                           rng.choice(tbl.columns["k0"].values.numpy(),
                                      3000)])
    kh, knull = _probe_hashes(tbl, [keys])
    hit, row = directory_probe(tbl, kh, knull)
    phit, prow = _plain_probe(tbl, [keys])
    assert torch.equal(hit, phit) and torch.equal(row, prow)
    assert int(hit.sum()) >= 3000


def test_duplicate_hashes_take_the_stable_sort_first_row():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 300, 4000)             # ~13 rows per key
    tbl = _table([keys])
    khs = tbl.keyhash_sorted
    assert int((khs[1:] == khs[:-1]).sum()) > 3000
    kh = _edge_hashes(tbl)
    got, _trips = directory_lookup(khs, tbl.directory, kh)
    assert torch.equal(got, torch.searchsorted(khs, kh, side="left"))
    probe = rng.integers(-50, 350, 5000)
    kh, knull = _probe_hashes(tbl, [probe])
    hit, row = directory_probe(tbl, kh, knull)
    phit, prow = _plain_probe(tbl, [probe])
    assert torch.equal(hit, phit) and torch.equal(row, prow)
    # a hit's row is the first build row of its key
    first = {}
    for r, v in enumerate(keys.tolist()):
        first.setdefault(v, r)
    for v, h, r in zip(probe.tolist(), hit.tolist(), row.tolist()):
        assert h == (v in first) and (not h or r == first[v])


def test_thousands_of_padding_rows_fill_the_last_bucket():
    rng = np.random.default_rng(11)
    n = 12000
    live = np.zeros(n, dtype=bool)
    live[rng.choice(n, 3000, replace=False)] = True   # 9000 dead rows
    tbl = _table([rng.integers(-10 ** 9, 10 ** 9, n)], live)
    khs = tbl.keyhash_sorted
    assert int((khs == INT64_MAX).sum()) == 9000
    d = tbl.directory
    assert int(d[-1] - d[-2]) >= 9000        # the last bucket holds them
    kh = _edge_hashes(tbl)
    got, trips = directory_lookup(khs, d, kh)
    want = torch.searchsorted(khs, kh, side="left")
    assert torch.equal(got, want)
    assert trips >= 13                       # the inside bisect is needed
    hit, _row = directory_probe(tbl, kh, torch.zeros_like(kh, dtype=bool))
    assert torch.equal(hit, khs[want.clamp(0, n - 1)] == kh)
    probe = np.concatenate([rng.integers(-10 ** 9, 10 ** 9, 2000),
                            tbl.columns["k0"].values.numpy()[live][:2000],
                            tbl.columns["k0"].values.numpy()[~live][:2000]])
    kh, knull = _probe_hashes(tbl, [probe])
    hit, row = directory_probe(tbl, kh, knull)
    phit, prow = _plain_probe(tbl, [probe])
    assert torch.equal(hit, phit) and torch.equal(row, prow)


def test_null_keys_never_hit():
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 500, 2000), rng.integers(0, 40, 2000)
    tbl = _table([a, b])
    pa, pb = a[rng.integers(0, 2000, 4000)], b[rng.integers(0, 2000, 4000)]
    pa[:2000], pb[:2000] = a[:2000], b[:2000]       # hits
    nulls = [rng.random(4000) < 0.2, rng.random(4000) < 0.1]
    kh, knull = _probe_hashes(tbl, [pa, pb], nulls)
    hit, row = directory_probe(tbl, kh, knull)
    phit, prow = _plain_probe(tbl, [pa, pb], nulls)
    assert torch.equal(hit, phit) and torch.equal(row, prow)
    assert not bool(hit[knull].any()) and bool(hit[:2000][~knull[:2000]].all())


def test_reference_two_column_probe_equals_the_directory():
    """PARTSUPP's shape: a unique table on (partkey, suppkey), probed by
    two key columns.  The reference's applier (JAX, on the CPU) and the
    directory model, on the same numpy inputs, give the same hits and
    build rows."""
    rng = np.random.default_rng(5)
    n = 8000
    part = np.repeat(np.arange(1, n // 4 + 1, dtype=np.int64), 4)
    supp = (part * 7 + np.tile(np.arange(4), n // 4) * 2501) % 1000 + 1
    probe_p = rng.integers(1, n // 4 + 400, 20000).astype(np.int64)
    probe_s = np.where(rng.random(20000) < 0.7,
                       (probe_p * 7 + rng.integers(0, 4, 20000) * 2501)
                       % 1000 + 1, rng.integers(1, 1001, 20000))
    # the reference: its build table and its applier
    jtbl = jops.build_table(jbatch.Batch(
        {"k0": jbatch.Column(jnp.asarray(part)),
         "k1": jbatch.Column(jnp.asarray(supp))},
        jnp.ones(n, dtype=bool)), ["k0", "k1"])
    rowid = jnp.arange(n, dtype=jnp.int64)
    sp = jjoin.JoinStepPlan(0, "join", "unique", False, ("k0", "k1"), "",
                            (("rowid", False),), 3)
    applier = jjoin._make_applier(sp, (jtbl.keyhash_sorted, jtbl.perm,
                                       rowid))
    out = applier(jbatch.Batch(
        {"k0": jbatch.Column(jnp.asarray(probe_p)),
         "k1": jbatch.Column(jnp.asarray(probe_s))},
        jnp.ones(20000, dtype=bool)))
    jhit = np.asarray(out.mask)
    jrow = np.where(jhit, np.asarray(out.columns["rowid"].values), 0)
    # the port: the same table, then the kernel's lookup
    tbl = _table([part, supp])
    assert np.array_equal(tbl.keyhash_sorted.numpy(),
                          np.asarray(jtbl.keyhash_sorted))
    kh, knull = _probe_hashes(tbl, [probe_p, probe_s])
    hit, row = directory_probe(tbl, kh, knull)
    assert np.array_equal(hit.numpy(), jhit)
    assert np.array_equal(row.numpy(), jrow)
    assert 0.5 < jhit.mean() < 0.9


def test_empty_directory_bits():
    assert tjoin.directory_bits(0) == 1
    assert tjoin.directory_bits(1) == 2 and tjoin.directory_bits(4000) == 13
    d = tjoin.bucket_directory(torch.zeros(0, dtype=torch.int64))
    assert d.tolist() == [0, 0, 0]


@pytest.mark.parametrize("n", [1, 4000, 65536])
def test_directory_built_in_chunks_equals_one_search(monkeypatch, n):
    """bucket_directory's chunked build (DIRECTORY_CHUNK buckets at a
    time, a ragged last chunk here) equals one searchsorted over every
    bucket's first hash."""
    rng = np.random.default_rng(n + 7)
    khs = torch.sort(ops._orderable_hash(ops.hash_columns([Column(
        torch.from_numpy(rng.integers(-10 ** 12, 10 ** 12, n)))]))).values
    k = tjoin.directory_bits(n)
    starts = torch.tensor([(b - (1 << (k - 1))) << (64 - k)
                           for b in range(1 << k)], dtype=torch.int64)
    want = torch.cat([torch.searchsorted(khs, starts, side="left"),
                      torch.tensor([n])]).to(torch.int32)
    monkeypatch.setattr(tjoin, "DIRECTORY_CHUNK", 1000)
    assert torch.equal(tjoin.bucket_directory(khs), want)
