"""Sampled-negative ranking evaluator (JAX rebuild).

Behavioural spec from `/root/reference/cymf/evaluator.pyx`:

* candidates per user = all test positives (label 1) + ``num_negatives``
  uniform negatives rejection-sampled against train+test positives
  (`evaluator.pyx:95-111`);
* scores = ``H[items] @ W[user]``, sorted descending (`evaluator.pyx:113`);
* per (metric, k) the reference's exact metric formulas are applied and the
  result is averaged over **all** users, with users that have no test
  positives contributing 0 (`evaluator.pyx:91-92` skips them but their slot
  in the mean stays 0);
* propensity scores for the IPS variants = per-item mean of the test matrix,
  clipped at 1e-4 (`evaluator.pyx:50`).

The rebuild replaces the serial per-user Python loop with a user-chunked,
fully vectorized pipeline: negatives are drawn in one batch with
``jax.random``, rejection probes the granule-aligned pair hash set
(:func:`cymf_tpu.ops.hashset.hashset_contains`, two row-gathers instead of
a 32-round binary search) with collision *masking*, scoring is one
``(C, L, K) x (C, K)`` contraction per chunk, ranking is
``lax.top_k(kmax)`` (every metric numerator only touches ranks <
``max(k)``, and the denominators are order-invariant sums — no full
argsort), and all metrics are computed in a single fused pass.  Chunks of
the same padded shape are stacked and processed by ONE ``lax.map``-scanned
dispatch (per-chunk dispatch overhead dominates small-table evaluation).

On a multi-device mesh the per-user work — negative draws, candidate
scoring, top-k, metrics — is partitioned over users with an explicit
``shard_map`` (users sharded, tables/hash-set replicated: the per-chunk
score matrices, not the factor tables, are the memory/FLOP cost of
evaluation), with a single ``psum`` of the [n_metrics, n_ks] sums as the
only collective.  Per-device FLOPs shrink ~n-fold
(``tests/test_sharding_hlo.py``).  Each user's negatives come from a key
folded with its user id, so the sharded path draws exactly the
single-device negatives and its metrics match up to float summation
order.

Fixed reference defects (SURVEY.md §7 "known defects", do-not-replicate):

* the f-string typo ``f"{metric)}@{k}"`` (`evaluator.pyx:89,137`);
* the IPS propensity indexing bug: `evaluator.pyx:114` indexes
  ``propensity_scores`` by *sort position* instead of by item id; we gather
  the propensity of the actual candidate item.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

from .. import config
from ..ops.hashset import build_pair_hashset, hashset_contains
from . import metrics as M

_TOPK_METRIC_FNS = {
    ("DCG", False): M.dcg_topk_batch,
    ("Recall", False): M.recall_topk_batch,
    ("MAP", False): M.average_precision_topk_batch,
    ("DCG", True): M.dcg_with_ips_topk_batch,
    ("Recall", True): M.recall_with_ips_topk_batch,
    ("MAP", True): M.average_precision_with_ips_topk_batch,
}

NEG_OVERSAMPLE = 2   # candidates drawn per refill round, x num_negatives
MAX_FILL_ROUNDS = 64  # safety cap: a user whose positives cover the whole
#                       catalog has no valid negative (the reference would
#                       spin forever at evaluator.pyx:106-111); we stop after
#                       MAX_FILL_ROUNDS and mask the (impossible) shortfall.


def draw_negatives(user_ids, hs, key, num_items: int, num_negatives: int,
                   dtype=jnp.int32):
    """Exactly ``num_negatives`` uniform negatives per user.

    Matches the reference's rejection loop (`evaluator.pyx:106-111`): draw
    uniform items, discard any that is a train/test positive, repeat *until*
    every user has ``num_negatives`` valid candidates (duplicates allowed,
    as in the reference).  Runs as a ``lax.while_loop`` of vectorized rounds;
    round 1 suffices unless a user's positives cover >~3/4 of the catalog.

    Round ``r``'s draws for user ``u`` come from ``fold_in(fold_in(key,
    u), r)``: a user's negatives do not depend on which other users share
    its chunk or its device.

    Returns (neg_items int[C, num_negatives], neg_valid bool[C, num_negatives]).
    """
    C = user_ids.shape[0]
    R = NEG_OVERSAMPLE * num_negatives
    flat_users = jnp.repeat(user_ids, R)
    user_keys = jax.vmap(functools.partial(jax.random.fold_in, key))(
        user_ids)

    def cond(state):
        _, count, rounds = state
        return jnp.any(count < num_negatives) & (rounds < MAX_FILL_ROUNDS)

    def body(state):
        neg, count, rounds = state
        draws = jax.vmap(lambda k: jax.random.randint(
            jax.random.fold_in(k, rounds), (R,), 0, num_items,
            dtype=dtype))(user_keys)
        valid = ~hashset_contains(hs, flat_users,
                                  draws.reshape(-1)).reshape(C, R)
        # destination slot of each valid draw, in draw order; slots beyond
        # num_negatives (and invalid draws) fall off via mode="drop"
        dest = count[:, None] + jnp.cumsum(valid, axis=-1) - 1
        dest = jnp.where(valid, dest, num_negatives)
        neg = jax.vmap(lambda n, d, v: n.at[d].set(v, mode="drop"))(
            neg, dest, draws)
        count = jnp.minimum(count + jnp.sum(valid, axis=-1), num_negatives)
        return neg, count, rounds + 1

    init = (jnp.zeros((C, num_negatives), dtype),
            jnp.zeros((C,), jnp.int32), jnp.zeros((), jnp.int32))
    neg, count, _ = jax.lax.while_loop(cond, body, init)
    neg_valid = jnp.arange(num_negatives)[None, :] < count[:, None]
    return neg, neg_valid


def _chunk_metric_sums(W, H, user_ids, pos_pad, pos_valid, hs, props, key, *,
                       num_negatives: int, ks: tuple, metric_names: tuple,
                       unbiased: bool):
    """[n_metrics, n_ks] metric SUMS over one chunk of users.

    Args:
      W: [U, K] user table;  H: [I, K] item table.
      user_ids: int32[C] global user ids for this chunk.
      pos_pad: int32[C, P] padded test-positive item ids.
      pos_valid: bool[C, P] validity mask for ``pos_pad``.
      hs: PairHashSet of train+test positives (rejection set).
      props: float[I] per-item propensities.
      key: PRNG key for this chunk's negative draws.

    Users without test positives contribute 0 (`evaluator.pyx:91-92`).
    """
    C, P = pos_pad.shape
    I = H.shape[0]

    # --- negatives: rejection-sample until exactly num_negatives per user
    # (evaluator.pyx:106-111 parity — no silent shortfall on dense users).
    neg_items, neg_valid = draw_negatives(
        user_ids, hs, key, I, num_negatives, dtype=pos_pad.dtype)

    # --- candidate list: positives then negatives (L = P + num_negatives).
    cand = jnp.concatenate([pos_pad, neg_items], axis=-1)
    valid = jnp.concatenate([pos_valid, neg_valid], axis=-1)
    labels = jnp.concatenate(
        [pos_valid.astype(W.dtype),
         jnp.zeros((C, num_negatives), W.dtype)], axis=-1)

    # --- score; invalid slots sink to -inf.  Only the top
    # kmax ranks feed any metric numerator (metrics.py top-k forms), so
    # rank with lax.top_k instead of a full argsort.  Ties resolve to the
    # lower candidate index in both, so this is exactly the argsort path.
    h = H[cand]                                   # [C, L, K]
    w = W[user_ids]                               # [C, K]
    scores = jnp.einsum("clk,ck->cl", h, w,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
    scores = jnp.where(valid, scores, -jnp.inf)
    kmax = min(max(max(ks), 1), int(cand.shape[-1]))
    _, top_idx = jax.lax.top_k(scores, kmax)
    labels_top = jnp.take_along_axis(labels, top_idx, axis=-1)
    # order-invariant denominators over the FULL candidate list
    total_pos = jnp.sum(pos_valid, axis=-1).astype(W.dtype)
    if unbiased:
        props_top = jnp.take_along_axis(props[cand], top_idx, axis=-1)
        sn_total = jnp.sum(
            jnp.where(pos_valid, 1.0 / props[pos_pad], 0.0), axis=-1)

    out = []
    for name in metric_names:
        fn = _TOPK_METRIC_FNS[(name, unbiased)]
        row = []
        for k in ks:
            row.append(fn(labels_top, props_top, sn_total, k) if unbiased
                       else fn(labels_top, total_pos, k))
        out.append(jnp.stack(row))
    return jnp.sum(jnp.stack(out), axis=-1)  # [n_metrics, n_ks]


@functools.partial(
    jax.jit,
    static_argnames=("num_negatives", "ks", "metric_names", "unbiased"))
def _evaluate_group(W, H, uids_g, pos_g, valid_g, hs, props, keys_g, *,
                    num_negatives: int, ks: tuple, metric_names: tuple,
                    unbiased: bool):
    """Metric sums over a [G, C, ...] stack of same-shape chunks — ONE
    dispatch per shape group (sequential ``lax.map`` over chunks)."""
    def one(args):
        uids, pos, valid, key = args
        return _chunk_metric_sums(
            W, H, uids, pos, valid, hs, props, key,
            num_negatives=num_negatives, ks=ks, metric_names=metric_names,
            unbiased=unbiased)

    return jnp.sum(jax.lax.map(one, (uids_g, pos_g, valid_g, keys_g)),
                   axis=0)


@functools.lru_cache(maxsize=32)
def _sharded_group_eval(mesh_ctx, num_negatives: int, ks: tuple,
                        metric_names: tuple, unbiased: bool):
    """Jitted shard_map group evaluator: users sharded over the mesh axis,
    tables/hash-set replicated, one [n_metrics, n_ks] psum per group.
    Negatives are keyed per user (:func:`draw_negatives`), so every
    device draws its users' single-device negatives."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import ROW_AXIS

    def device_eval(W, H, uids_g, pos_g, valid_g, hs, props, keys_g):
        def one(args):
            uids, pos, valid, key = args
            return _chunk_metric_sums(
                W, H, uids, pos, valid, hs, props, key,
                num_negatives=num_negatives, ks=ks,
                metric_names=metric_names, unbiased=unbiased)

        local = jnp.sum(jax.lax.map(one, (uids_g, pos_g, valid_g, keys_g)),
                        axis=0)
        return jax.lax.psum(local, ROW_AXIS)

    rep = P()
    users2 = P(None, ROW_AXIS)
    users3 = P(None, ROW_AXIS, None)
    fn = jax.shard_map(
        device_eval, mesh=mesh_ctx.mesh,
        in_specs=(rep, rep, users2, users3, users3, rep, rep, rep),
        out_specs=rep, check_vma=False)
    return jax.jit(fn)


class Evaluator:
    """API-compatible rebuild of ``cymf.evaluator.Evaluator``.

    ``evaluate(W, H, seed)`` returns ``{f"{metric}@{k}": float}`` averaged
    over all users of the test matrix.
    """

    def __init__(self, X, X_train=None,
                 metrics: Sequence[str] = ("DCG", "Recall", "MAP"),
                 k: Union[int, Sequence[int]] = 5,
                 num_negatives: int = 100,
                 unbiased: bool = False):
        X = sparse.csr_matrix(X)
        user_positives = X.copy()
        if X_train is not None:
            user_positives = user_positives + sparse.csr_matrix(X_train)
        X = X.astype(np.float64)
        user_positives = user_positives.astype(np.float64)
        user_positives.sort_indices()
        X.sort_indices()

        self.X = X
        self.user_positives = user_positives
        # per-item mean of the *test* matrix, clipped (evaluator.pyx:50)
        self.propensity_scores = np.maximum(
            np.asarray(X.mean(axis=0)).flatten(), 1e-4)
        self.metrics = list(metrics)
        self.k = k
        self.num_negatives = int(num_negatives)
        self.unbiased = bool(unbiased)

        self._user_chunks = self._build_user_chunks(X)
        self._device_state = None

    def _build_user_chunks(self, X, max_chunk: int = 4096,
                           max_elems: int = 1 << 22):
        """Degree-bucketed user chunks (like the ALS chunker): users are
        sorted by test-positive count ascending and grouped so each chunk's
        padded candidate matrix stays bounded — one heavy user no longer
        forces a huge pad onto every chunk.  Chunk user counts round UP to
        a power of two (dummy zero-mask users pad the tail) so most chunks
        share one shape — fewer distinct compiles and fewer dispatches
        after same-shape stacking."""
        U = X.shape[0]
        deg = np.diff(X.indptr)
        order = np.argsort(deg, kind="stable")
        chunks = []
        start = 0
        while start < U:
            take = 1
            while take < max_chunk and start + take < U:
                pmax = max(int(deg[order[start + take]]), 1)
                P = 1
                while P < pmax:
                    P *= 2
                if (take + 1) * (P + self.num_negatives) > max_elems:
                    break
                take += 1
            sel = order[start:start + take].astype(np.int32)
            start += take
            p2 = 1
            while p2 < take:
                p2 *= 2
            pmax = max(int(deg[sel].max()) if len(sel) else 1, 1)
            P = 1
            while P < pmax:
                P *= 2
            pos_pad = np.zeros((p2, P), np.int32)
            pos_valid = np.zeros((p2, P), bool)
            uids = np.zeros(p2, np.int32)
            uids[:take] = sel
            for r, u in enumerate(sel):
                lo, hi = X.indptr[u], X.indptr[u + 1]
                pos_pad[r, :hi - lo] = X.indices[lo:hi]
                pos_valid[r, :hi - lo] = True
            chunks.append((uids, pos_pad, pos_valid))
        return chunks

    def _group_chunks(self, pad_multiple: int):
        """Stack same-shape chunks into [G, C, ...] groups (one dispatch
        per group).  Chunks are user-padded to ``pad_multiple`` (the mesh
        size) with dummy users whose all-False positive masks contribute
        exactly 0 to every metric sum."""
        by_shape = {}
        for ci, (sel, pos_pad, pos_valid) in enumerate(self._user_chunks):
            C = len(sel)
            Cp = -(-max(C, 1) // pad_multiple) * pad_multiple
            if Cp != C:
                sel = np.pad(sel, (0, Cp - C))
                pos_pad = np.pad(pos_pad, ((0, Cp - C), (0, 0)))
                pos_valid = np.pad(pos_valid, ((0, Cp - C), (0, 0)))
            by_shape.setdefault(pos_pad.shape, []).append(
                (sel, pos_pad, pos_valid, ci))
        groups = []
        for shape, items in by_shape.items():
            groups.append((
                np.stack([s for s, _, _, _ in items]),
                np.stack([p for _, p, _, _ in items]),
                np.stack([v for _, _, v, _ in items]),
                np.asarray([c for _, _, _, c in items], np.int32)))
        return groups

    def _to_device(self, mesh):
        """Device-resident evaluation state for ``mesh``: stacked chunk
        groups (user dim sharded over the mesh when multi-device), the
        rejection hash set and propensities replicated."""
        n = mesh.num_devices
        # keyed on the MeshContext itself, not just the device count:
        # arrays committed to a previous same-size mesh must not leak
        # into a new mesh's shard_map
        if self._device_state is None or self._device_state["mesh"] != mesh:
            up = self.user_positives.tocoo()
            put_rep = mesh.put_replicated if n > 1 else jnp.asarray
            if n > 1:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from ..parallel.mesh import ROW_AXIS
                sh2 = NamedSharding(mesh.mesh, P(None, ROW_AXIS))
                sh3 = NamedSharding(mesh.mesh, P(None, ROW_AXIS, None))
                put2 = functools.partial(jax.device_put, device=sh2)
                put3 = functools.partial(jax.device_put, device=sh3)
            else:
                put2 = put3 = jnp.asarray
            self._device_state = dict(
                n=n, mesh=mesh,
                groups=[(put2(u), put3(p), put3(v), jnp.asarray(c))
                        for u, p, v, c in self._group_chunks(n)],
                hs=jax.tree_util.tree_map(
                    put_rep, build_pair_hashset(up.row, up.col)),
                props=put_rep(np.asarray(self.propensity_scores,
                                         dtype=config.param_dtype())),
            )
        return self._device_state

    def evaluate(self, W, H, seed: int = 1234) -> dict:
        ks = ((int(self.k),) if isinstance(self.k, int)
              else tuple(int(k) for k in self.k))
        metric_names = tuple(self.metrics)

        from ..parallel.mesh import current_mesh
        mesh = current_mesh()
        n = mesh.num_devices
        U, I = self.X.shape
        put_rep = mesh.put_replicated if n > 1 else jnp.asarray
        Wd = put_rep(np.asarray(W, dtype=config.param_dtype()))
        Hd = put_rep(np.asarray(H, dtype=config.param_dtype()))
        st = self._to_device(mesh)
        if n > 1:
            run = _sharded_group_eval(mesh, self.num_negatives, ks,
                                      metric_names, self.unbiased)
        else:
            run = functools.partial(
                _evaluate_group, num_negatives=self.num_negatives, ks=ks,
                metric_names=metric_names, unbiased=self.unbiased)

        key = jax.random.PRNGKey(seed)
        # accumulate on device and fetch ONCE: group dispatches stay
        # async and pipeline (a per-group device_get would serialize every
        # dispatch behind a host round-trip)
        total = None
        for uids_g, pos_g, valid_g, cis in st["groups"]:
            keys_g = jax.vmap(functools.partial(jax.random.fold_in, key))(
                cis)
            part = run(Wd, Hd, uids_g, pos_g, valid_g, st["hs"],
                       st["props"], keys_g)
            total = part if total is None else total + part
        sums = np.asarray(total, dtype=np.float64)

        buff = {}
        for mi, name in enumerate(metric_names):
            for ki, k in enumerate(ks):
                buff[f"{name}@{k}"] = sums[mi, ki] / max(U, 1)
        return buff


class AverageOverAllEvaluator(Evaluator):
    """`evaluator.pyx:141-145`."""

    def __init__(self, X, X_train=None,
                 metrics: Sequence[str] = ("DCG", "Recall", "MAP"),
                 k: Union[int, Sequence[int]] = 5, num_negatives: int = 100):
        super().__init__(X, X_train, metrics, k, num_negatives,
                         unbiased=False)


AoaEvaluator = AverageOverAllEvaluator


class UnbiasedEvaluator(Evaluator):
    """`evaluator.pyx:147-149`."""

    def __init__(self, X, X_train=None,
                 metrics: Sequence[str] = ("DCG", "Recall", "MAP"),
                 k: Union[int, Sequence[int]] = 5, num_negatives: int = 100):
        super().__init__(X, X_train, metrics, k, num_negatives, unbiased=True)
