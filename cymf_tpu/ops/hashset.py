"""Exact (user, item)-pair membership via a bucketized two-level hash set.

Replaces the vectorized binary search of :func:`cymf_tpu.ops.segment.csr_contains`
on the training hot path.  The binary search costs ~32 *dependent* gather
rounds per query batch; this hash set answers the same query with two
independent row-gathers (one per level).

Layout: two levels of bucketized tables, int32 arrays of shape
``(num_buckets, 2 * SLOTS)`` — slots ``[:, :SLOTS]`` hold user ids,
``[:, SLOTS:]`` hold item ids; one row-gather fetches a whole bucket.
Level 1 uses 64-way buckets, so a row is 128 int32 = 512 bytes (a layout
chosen for a 128-lane tiling; on the GPU a probe reads the whole 512-byte
row, and whether narrower buckets probe faster there is unmeasured —
ROADMAP).  Empty slots hold -1.
Pairs that overflow their level-1 bucket go to level 2 (different hash
salt, small enough to stay cache-resident); the host builder grows level 2
until nothing overflows, so queries are EXACT — no Bloom-style false
positives, preserving the reference's rejection semantics
(`/root/reference/cymf/bpr.pyx:166-167`) bit-for-bit in masked form.

The host build is fully vectorized numpy (sort by bucket, rank within run);
~1 s for ML-20M's 20M pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_SLOTS1 = 64   # level-1: 128-lane rows, zero padding
_SLOTS2 = 16   # level-2: small overflow table
_SALT1 = np.uint32(0x9E3779B1)
_SALT2 = np.uint32(0x7FEB352D)


def _mix_np(u: np.ndarray, i: np.ndarray, salt: np.uint32) -> np.ndarray:
    """32-bit mixing of a pair (murmur3-style finalizer). Must stay in sync
    with :func:`_mix_jnp`."""
    x = (u.astype(np.uint32) * np.uint32(0x85EBCA6B)
         + i.astype(np.uint32) * np.uint32(0xC2B2AE35) + salt)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _mix_jnp(u: jax.Array, i: jax.Array, salt: int) -> jax.Array:
    x = (u.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
         + i.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35) + jnp.uint32(salt))
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


class PairHashSet(NamedTuple):
    table1: jax.Array  # int32[NB1, 128]
    table2: jax.Array  # int32[NB2, 32]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _place(users: np.ndarray, items: np.ndarray, num_buckets: int,
           salt: np.uint32, slots: int):
    """Pack pairs into ``slots``-way buckets; returns (table, overflow)."""
    b = (_mix_np(users, items, salt) & np.uint32(num_buckets - 1)).astype(
        np.int64)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    # rank within each equal-bucket run
    if len(bs) > 1:
        new_run = np.r_[True, bs[1:] != bs[:-1]]
    else:
        new_run = np.ones(len(bs), dtype=bool)
    run_ids = np.cumsum(new_run) - 1
    first_pos = np.flatnonzero(new_run)
    rank = np.arange(len(bs)) - first_pos[run_ids]
    fits = rank < slots

    table = np.full((num_buckets, 2 * slots), -1, dtype=np.int32)
    sel = order[fits]
    table[bs[fits], rank[fits]] = users[sel]
    table[bs[fits], slots + rank[fits]] = items[sel]
    overflow = np.zeros(len(users), dtype=bool)
    overflow[order[~fits]] = True
    return table, overflow


def build_pair_hashset(users: np.ndarray, items: np.ndarray) -> PairHashSet:
    """Build from interaction arrays (duplicates deduplicated first)."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    key = users * (items.max(initial=0) + 1) + items
    _, uniq_idx = np.unique(key, return_index=True)
    users = users[uniq_idx].astype(np.int32)
    items = items[uniq_idx].astype(np.int32)
    nnz = len(users)

    # level-1 load ~32/64: overflow is rare and goes to the small level 2
    nb1 = _next_pow2(max(nnz // 32, 1))
    table1, of = _place(users, items, nb1, _SALT1, _SLOTS1)
    u2, i2 = users[of], items[of]
    nb2 = _next_pow2(max(len(u2) // 4, 1))
    for _ in range(8):
        table2, of2 = _place(u2, i2, nb2, _SALT2, _SLOTS2)
        if not of2.any():
            break
        nb2 *= 2
    else:
        raise RuntimeError("hash set build failed to converge")
    return PairHashSet(jnp.asarray(table1), jnp.asarray(table2))


def hashset_contains(hs: PairHashSet, u: jax.Array,
                     i: jax.Array) -> jax.Array:
    """bool[B]: is the pair (u[b], i[b]) in the set?  Two row-gathers."""
    u32 = u.astype(jnp.int32)
    i32 = i.astype(jnp.int32)

    def level(table, salt):
        nb = table.shape[0]
        slots = table.shape[1] // 2
        b = (_mix_jnp(u32, i32, salt) & jnp.uint32(nb - 1)).astype(jnp.int32)
        row = table[b]                                   # (B, 2*slots)
        hit = jnp.any((row[:, :slots] == u32[:, None])
                      & (row[:, slots:] == i32[:, None]), axis=1)
        return hit

    return level(hs.table1, int(_SALT1)) | level(hs.table2, int(_SALT2))
