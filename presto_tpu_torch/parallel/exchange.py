"""Partitioned exchange over the device mesh (the port of
presto_tpu/parallel/exchange.py): the device-resident replacement for the
HTTP pull shuffle between hash-partitioned stages
(PartitionedOutputOperator.java:58 -> ExchangeClient.java:72).

Where producer and consumer stages are pinned to the positions of one
mesh (parallel/mesh.py), each producer buckets its rows by target
partition (hash of the partition keys mod the position count) into
fixed-quota buckets, and the exchange moves bucket d of every producer to
position d: the all_to_all of the reference, as torch ops on the devices.
No row crosses the host.  Where positions share a card the move is a
device copy; on distinct cards it is a peer copy.  Bucket overflow is
computed on the device and returned unread.

The scheduler's chunked mode (exec/scheduler.py _ici_exchange,
exchange.ici-chunk-rows) calls the exchange once per fixed-size row chunk
with quota == chunk rows: a chunk of C rows can never put more than C rows
in one bucket, so overflow is statically impossible and every chunk is
queued back to back with no host sync -- the card works on chunk k+1's
exchange while the consumer's work on chunk k waits behind it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..exec.batch import Batch, Column
from ..exec.operators import hash_columns, umod
from .mesh import DeviceMesh


def partition_targets(batch: Batch, key_names: List[str], n_parts: int,
                      salt: int = 0) -> torch.Tensor:
    """Each row's target position (int64): the key columns' combined hash
    mod n_parts (unsigned, as the reference's uint64 remainder), or round
    robin over the live rows without keys; dead rows get n_parts."""
    if key_names:
        h = hash_columns([batch.columns[k] for k in key_names], salt)
        target = umod(h, n_parts)
    else:
        target = (torch.cumsum(batch.mask.to(torch.int64), 0) - 1) % n_parts
    return torch.where(batch.mask, target, torch.full_like(target, n_parts))


def bucket_locally(batch: Batch, key_names: List[str], n_parts: int,
                   quota: int, salt: int = 0):
    """Reorder local rows into n_parts buckets of `quota` rows each (the
    reference's _bucket_locally).

    Returns (bucketed columns dict name -> Column of n_parts*quota rows,
    bucketed mask, overflow flag as a 0-dim bool tensor, unread)."""
    target = partition_targets(batch, key_names, n_parts, salt)
    order = torch.argsort(target, stable=True)       # rows grouped by target
    sorted_target = target[order]
    # position of each row within its bucket
    ranks = torch.arange(batch.capacity, device=target.device) \
        - torch.searchsorted(sorted_target, sorted_target, side="left")
    live = sorted_target < n_parts
    valid = live & (ranks < quota)
    counts = torch.zeros(n_parts + 1, dtype=torch.int64,
                         device=target.device)
    counts.index_add_(0, sorted_target, live.to(torch.int64))
    overflow = (counts[:n_parts] > quota).any()
    # slot in the bucketed layout; overflow rows go to a dropped slot
    dest = torch.where(valid, sorted_target * quota + ranks,
                       torch.full_like(ranks, n_parts * quota))
    size = n_parts * quota

    def scatter(sorted_src):
        buf = torch.zeros((size + 1,) + tuple(sorted_src.shape[1:]),
                          dtype=sorted_src.dtype, device=sorted_src.device)
        buf[dest] = sorted_src
        return buf[:size]

    out_cols = {}
    for name, col in batch.columns.items():
        nulls = None if col.nulls is None else scatter(col.nulls[order])
        out_cols[name] = Column(scatter(col.values[order]), nulls,
                                col.dictionary, col.lazy)
    return out_cols, scatter(valid), overflow


def exchange_step(batches: Sequence[Batch], key_names: Tuple[str, ...],
                  devices: Sequence[torch.device], quota: int,
                  salt: int = 0):
    """One exchange over the mesh: `batches[p]` is producer p's batch on
    `devices[p]`.  Returns (the exchanged Batch of every position d, on
    devices[d], with n*quota rows: producer p's bucket d at rows
    p*quota..(p+1)*quota, as the all_to_all stacks them; the overflow
    flag anywhere, a 0-dim bool tensor on devices[0], unread)."""
    n = len(devices)
    bucketed = [bucket_locally(b, list(key_names), n, quota, salt)
                for b in batches]

    def a2a(parts: List[torch.Tensor], d: int) -> torch.Tensor:
        # bucket d of every producer, moved to position d (a no-op move
        # where positions share a device)
        dev = devices[d]
        return torch.cat([t[d * quota:(d + 1) * quota].to(
            dev, non_blocking=True) for t in parts])

    names = list(bucketed[0][0])
    template = bucketed[0][0]
    outs = []
    for d in range(n):
        cols = {}
        for name in names:
            c = template[name]
            values = a2a([bk[0][name].values for bk in bucketed], d)
            nulls = (a2a([bk[0][name].nulls for bk in bucketed], d)
                     if c.nulls is not None else None)
            cols[name] = Column(values, nulls, c.dictionary, c.lazy)
        outs.append(Batch(cols, a2a([bk[1] for bk in bucketed], d)))
    overflow = torch.stack([bk[2].to(devices[0], non_blocking=True)
                            for bk in bucketed]).any()
    return outs, overflow


def make_partitioned_exchange(mesh: DeviceMesh, key_names: Tuple[str, ...],
                              quota: int, salt: int = 0):
    """The exchange over `mesh` as one callable: a list of per-position
    batches -> (per-position exchanged batches, overflow flag)."""
    devices = list(mesh.devices)
    keys = tuple(key_names)

    def exch(batches: Sequence[Batch]):
        return exchange_step(batches, keys, devices, quota, salt)
    return exch


def bucket_counts(batches: Sequence[Batch], key_names: List[str],
                  n_parts: int, salt: int = 0) -> List[torch.Tensor]:
    """Per producer, the live rows bound for each position (n_parts + 1
    counts, the last the dead rows), on the producer's device: what each
    consumer will receive, read with the producers' live counts in the
    scheduler's one host read."""
    out = []
    for b in batches:
        t = partition_targets(b, key_names, n_parts, salt)
        out.append(torch.bincount(t, minlength=n_parts + 1))
    return out
