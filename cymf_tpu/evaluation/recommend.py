"""Full-catalog top-k scorer / recommender (single-device and sharded).

The reference has no batch recommendation path at all — scoring happens only
inside the sampled-negative evaluator's per-user Python loop
(`/root/reference/cymf/evaluator.pyx:113`).  This module is the sharded
full-catalog scorer called for by the north star (BASELINE.json):

* single device: one ``(users_chunk x K) @ (K x items)`` matmul per
  chunk (float32 at ``precision=HIGHEST``, so no TF32 rounding reorders
  the top-k), train-positive exclusion by scatter-masking, ``jax.lax.top_k``.
* multi-device mesh: the catalog axis is **row-sharded** with an explicit
  ``shard_map`` — each device scores its item shard ``(C, K) @ (K, I/n)``,
  takes a LOCAL top-k, and the merge all-gathers only the ``n * k``
  per-shard candidates per user (comm is O(users x k), never O(items)).
  Per-device FLOPs shrink n-fold (``tests/test_sharding_hlo.py``).  Ties
  merge in ascending-item-id order on both paths, so the sharded result is
  bitwise-identical to the single-device one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

from .. import config
from ..parallel.mesh import ROW_AXIS, current_mesh


@functools.partial(jax.jit, static_argnames=("k",))
def _topk_chunk(W_chunk, H, excl_idx, excl_valid, *, k: int):
    scores = jnp.matmul(W_chunk, H.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
    C = W_chunk.shape[0]
    cols = jnp.where(excl_valid, excl_idx, H.shape[0])
    mask = jnp.zeros(scores.shape, bool).at[
        jnp.arange(C)[:, None], cols].set(True, mode="drop")
    scores = jnp.where(mask, -jnp.inf, scores)
    return jax.lax.top_k(scores, k)


@functools.lru_cache(maxsize=16)
def _topk_sharded(mesh_ctx, k: int, num_items: int):
    """Jitted shard_map distributed top-k: H row-sharded, users replicated.

    Per device: local scores over its item shard, local ``top_k``, then an
    ``all_gather`` of the (C, k) per-shard winners and a replicated merge.
    Padding rows of the sharded catalog are masked to -inf, and the
    gathered candidate order is ascending in global item id, so stable
    ``top_k`` tie-breaking matches the single-device full-row ``top_k``.
    """
    from jax.sharding import PartitionSpec as P

    def device_topk(W_chunk, H_shard, excl_idx, excl_valid):
        p = jax.lax.axis_index(ROW_AXIS)
        ipd = H_shard.shape[0]
        C = W_chunk.shape[0]
        scores = jnp.matmul(W_chunk, H_shard.T,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
        gid0 = p * ipd
        # catalog pad rows (beyond num_items) and excluded items -> -inf
        live = (gid0 + jnp.arange(ipd)) < num_items
        lidx = excl_idx - gid0
        # negative local ids would WRAP under .at[] — send them to the
        # drop sentinel explicitly (only >= ipd is out-of-bounds)
        cols = jnp.where(excl_valid & (lidx >= 0), lidx, ipd)
        mask = jnp.zeros(scores.shape, bool).at[
            jnp.arange(C)[:, None], cols].set(True, mode="drop")
        scores = jnp.where(mask | ~live[None, :], -jnp.inf, scores)
        kl = min(k, ipd)
        s_l, i_l = jax.lax.top_k(scores, kl)
        g_l = i_l + gid0
        s_all = jax.lax.all_gather(s_l, ROW_AXIS, axis=1, tiled=True)
        g_all = jax.lax.all_gather(g_l, ROW_AXIS, axis=1, tiled=True)
        s, pos = jax.lax.top_k(s_all, k)
        return s, jnp.take_along_axis(g_all, pos, axis=-1)

    rep = P()
    fn = jax.shard_map(
        device_topk, mesh=mesh_ctx.mesh,
        in_specs=(rep, P(ROW_AXIS, None), rep, rep),
        out_specs=(rep, rep), check_vma=False)
    return jax.jit(fn)


def recommend(W, H, k: int = 10, exclude=None,
              user_chunk: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items per user over the full catalog.

    Args:
      W: [U, K] user factors (numpy or jax array).
      H: [I, K] item factors.
      k: items to return per user.
      exclude: optional scipy sparse matrix of already-seen (train)
        interactions to exclude from recommendations.
      user_chunk: users scored per device matmul.

    Returns:
      (scores float32[U, k], items int32[U, k]) sorted by score descending.

    On a multi-device mesh the catalog is row-sharded and the top-k is
    merged from per-shard candidates (see :func:`_topk_sharded`).
    """
    mesh = current_mesh()
    n = mesh.num_devices
    Wd = jnp.asarray(W, config.param_dtype())
    U, K = Wd.shape
    I = np.shape(H)[0]
    if k > I:
        raise ValueError(f"k={k} exceeds catalog size {I}")

    if n > 1:
        Ipad = mesh.pad_rows(I)
        Hd = np.zeros((Ipad, K), np.asarray(H).dtype)
        Hd[:I] = np.asarray(H)
        Hd = mesh.put_table(jnp.asarray(Hd, config.param_dtype()))
        Wd = mesh.put_replicated(Wd)
        topk_fn = _topk_sharded(mesh, int(k), int(I))
    else:
        Hd = jnp.asarray(H, config.param_dtype())
        topk_fn = functools.partial(_topk_chunk, k=int(k))

    X = sparse.csr_matrix(exclude) if exclude is not None else None

    out_scores = np.empty((U, k), np.float32)
    out_items = np.empty((U, k), np.int32)
    for start in range(0, U, user_chunk):
        end = min(start + user_chunk, U)
        C = end - start
        # vectorized exclusion pads, sized per CHUNK (power of two: a
        # handful of distinct compiled shapes instead of padding every
        # chunk to the GLOBAL max degree — at ML-20M that would be a
        # (4096, ~9k) upload per chunk)
        if X is not None:
            lo = X.indptr[start:end].astype(np.int64)
            hi = X.indptr[start + 1:end + 1].astype(np.int64)
            d = hi - lo
            P = 1 << int(max(int(d.max()) if C else 1, 1) - 1).bit_length()
            excl_idx = np.zeros((C, P), np.int32)
            excl_valid = np.zeros((C, P), bool)
            total = int(hi[-1] - lo[0]) if C else 0
            if total:
                # consecutive users occupy one contiguous CSR region
                flat = X.indices[lo[0]:hi[-1]]
                rows = np.repeat(np.arange(C), d)
                pos = np.arange(total) - np.repeat(lo - lo[0], d)
                excl_idx[rows, pos] = flat
                excl_valid[rows, pos] = True
        else:
            excl_idx = np.zeros((C, 1), np.int32)
            excl_valid = np.zeros((C, 1), bool)
        s, idx = topk_fn(Wd[start:end], Hd, jnp.asarray(excl_idx),
                         jnp.asarray(excl_valid))
        out_scores[start:end] = np.asarray(s)
        out_items[start:end] = np.asarray(idx)
    return out_scores, out_items
