"""Dependency-free work partitioners, copied from the JAX package's
``distributed/sharding.py``: the lake's ``ScanPipeline.stream_sharded`` and
serving tier assign chunk groups to workers with them.  The logical-axis
mesh rules of that module come with ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

from typing import List


def shard_groups(n_items: int, n_shards: int) -> List[List[int]]:
    """Partition ``range(n_items)`` across ``n_shards`` workers round-robin
    in item order: shard ``w`` owns items ``w, w + n_shards, ...``.

    Round-robin (rather than contiguous blocks) keeps the *earliest* items
    at the head of every shard's list, so when items are chunk groups in
    plan order each worker starts on the group the consumer needs soonest —
    the serving tier's ordered re-merge then never waits on a worker that
    is busy with far-future groups.  Empty shards are dropped.
    """
    if n_items < 0 or n_shards <= 0:
        raise ValueError(f"invalid partition: {n_items} items, "
                         f"{n_shards} shards")
    shards = [list(range(w, n_items, n_shards)) for w in range(n_shards)]
    return [s for s in shards if s]


def shard_of(item: int, n_shards: int) -> int:
    """Inverse of :func:`shard_groups`: which shard owns ``item``."""
    if n_shards <= 0:
        raise ValueError(f"invalid shard count {n_shards}")
    return item % n_shards
