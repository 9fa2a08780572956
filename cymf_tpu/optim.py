"""Row-sparse optimizers with the reference's exact update semantics.

The reference optimizers (`/root/reference/cymf/optimizer.pyx`) apply
per-element updates from inside the Hogwild loop; only the (row, k) entries
actually touched by a sample are ever read or written.  The batched
equivalent is a *row-sparse* functional optimizer: a batch step produces
(rows, per-row gradients), duplicates are combined by
:func:`cymf_tpu.ops.segment.dedup_rows`, and the update is a scatter into the
row-sharded table + state.  Untouched rows are never read — no dense moment
decay, matching the reference's sparse-Adam behaviour.

Deliberately replicated quirks (they affect convergence, so parity requires
them — SURVEY.md §2 "Optimizers"):

* AdaGrad accumulators are initialized to **ones**, not zeros
  (`optimizer.pyx:69-70`), and there is no epsilon.
* Adam uses a **constant** bias correction ``1/(1-beta1)`` and ``1/(1-beta2)``
  instead of the usual ``1/(1-beta^t)`` — the reference keeps no timestep
  (`optimizer.pyx:150-160`).  Defaults beta1=0.9, beta2=0.999, eps=1e-8.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from .ops.segment import dedup_rows

State = Dict[str, Any]


class SparseOptimizer:
    """Functional optimizer over row-sharded tables.

    ``init(table)`` builds the per-table state pytree;
    ``update_rows(table, state, rows, grads)`` applies one synchronous sparse
    update.  ``rows`` may contain duplicates and out-of-range "drop" entries
    (>= table rows); both are handled here.

    ``update_dense(table, state, pairs)`` is an alternative execution
    strategy with identical semantics: per-sample gradients are scatter-added
    into a dense table-shaped buffer (duplicates combine natively — no sort
    needed) and the update is applied as a full-table pass masked to touched
    rows.  This wins whenever the batch touches a sizable fraction of the
    table (it also removes the argsort from the step).  ``pairs`` is a list of (rows, grads) contributions.
    """

    def init(self, table: jax.Array) -> State:
        raise NotImplementedError

    def update_rows(self, table: jax.Array, state: State, rows: jax.Array,
                    grads: jax.Array) -> Tuple[jax.Array, State]:
        raise NotImplementedError

    def update_dense(self, table: jax.Array, state: State, pairs,
                     rows_sorted: bool = False) -> Tuple[jax.Array, State]:
        raise NotImplementedError

    @staticmethod
    def _accumulate(table, pairs, with_mask: bool,
                    rows_sorted: bool = False):
        if len(pairs) == 1:
            rows, grads = pairs[0]
        else:  # one fused scatter beats several smaller ones
            rows = jnp.concatenate([r for r, _ in pairs])
            grads = jnp.concatenate([g for _, g in pairs])
            rows_sorted = False
        # indices_are_sorted lets XLA skip conflict serialization setup
        gbuf = jnp.zeros_like(table).at[rows].add(
            grads, indices_are_sorted=rows_sorted)
        if not with_mask:
            return gbuf, None
        # Rows whose accumulated gradient is exactly zero are either
        # untouched or touched only by masked-out (collision/padding)
        # samples; the reference skips those entirely (bpr.pyx:166-167), so
        # excluding them from the moment update is the faithful behaviour —
        # and it avoids a second scatter for the mask.
        touched = jnp.any(gbuf != 0, axis=-1, keepdims=True)
        return gbuf, touched


class Sgd(SparseOptimizer):
    """`optimizer.pyx:40-58`: ``param -= lr * grad``."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, table):
        return {}

    def update_rows(self, table, state, rows, grads):
        drop = table.shape[0]
        rows, grads = dedup_rows(rows, grads, drop)
        table = table.at[rows].add(-self.learning_rate * grads, mode="drop")
        return table, state

    def update_dense(self, table, state, pairs, rows_sorted=False):
        # untouched rows have zero accumulated gradient -> no-op naturally
        gbuf, _ = self._accumulate(table, pairs, with_mask=False,
                                   rows_sorted=rows_sorted)
        return table - self.learning_rate * gbuf, state


class AdaGrad(SparseOptimizer):
    """`optimizer.pyx:60-82`: accumulators start at ones, no epsilon."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, table):
        return {"accum": jnp.ones_like(table)}

    def update_rows(self, table, state, rows, grads):
        drop = table.shape[0]
        rows, grads = dedup_rows(rows, grads, drop)
        crows = jnp.clip(rows, 0, drop - 1)
        accum_new = state["accum"][crows] + jnp.square(grads)
        accum = state["accum"].at[rows].set(accum_new, mode="drop",
                                            unique_indices=True)
        delta = -self.learning_rate * grads * jax.lax.rsqrt(accum_new)
        table = table.at[rows].add(delta, mode="drop", unique_indices=True)
        return table, {"accum": accum}

    def update_dense(self, table, state, pairs, rows_sorted=False):
        # untouched rows: accum += 0 and delta = 0 -> no-op naturally
        gbuf, _ = self._accumulate(table, pairs, with_mask=False,
                                   rows_sorted=rows_sorted)
        accum = state["accum"] + jnp.square(gbuf)
        table = table - self.learning_rate * gbuf * jax.lax.rsqrt(accum)
        return table, {"accum": accum}


class Adam(SparseOptimizer):
    """`optimizer.pyx:126-160`: sparse Adam with constant bias correction."""

    def __init__(self, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        self.alpha = float(alpha)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)

    def init(self, table):
        return {"m": jnp.zeros_like(table), "v": jnp.zeros_like(table)}

    def update_rows(self, table, state, rows, grads):
        drop = table.shape[0]
        rows, grads = dedup_rows(rows, grads, drop)
        # Rows whose summed gradient is exactly zero were touched only by
        # masked-out samples (collision/padding); the reference *skips* those
        # (bpr.pyx:166-167), so their moments must not decay — same touched
        # semantics as update_dense.  Known deviation: a LIVE sample whose
        # gradient underflows to exactly 0.0 (saturated pair, wd=0) is also
        # treated as untouched here, whereas the reference would still decay
        # that row's moments; the gradient signal is identical (zero).
        rows = jnp.where(jnp.any(grads != 0, axis=tuple(range(1, grads.ndim))),
                         rows, drop)
        crows = jnp.clip(rows, 0, drop - 1)
        m_new = self.beta1 * state["m"][crows] + (1.0 - self.beta1) * grads
        v_new = (self.beta2 * state["v"][crows]
                 + (1.0 - self.beta2) * jnp.square(grads))
        m = state["m"].at[rows].set(m_new, mode="drop", unique_indices=True)
        v = state["v"].at[rows].set(v_new, mode="drop", unique_indices=True)
        # Constant bias correction — deliberate parity with the reference.
        m_hat = m_new / (1.0 - self.beta1)
        v_hat = v_new / (1.0 - self.beta2)
        delta = -self.alpha * m_hat / (jnp.sqrt(v_hat) + self.epsilon)
        table = table.at[rows].add(delta, mode="drop", unique_indices=True)
        return table, {"m": m, "v": v}

    def update_dense(self, table, state, pairs, rows_sorted=False):
        # Adam's moment decay must only touch rows present in the batch
        # (sparse-Adam semantics, optimizer.pyx per-element updates) -> mask.
        gbuf, touched = self._accumulate(table, pairs, with_mask=True,
                                         rows_sorted=rows_sorted)
        m = jnp.where(touched,
                      self.beta1 * state["m"] + (1.0 - self.beta1) * gbuf,
                      state["m"])
        v = jnp.where(touched,
                      self.beta2 * state["v"]
                      + (1.0 - self.beta2) * jnp.square(gbuf),
                      state["v"])
        delta = jnp.where(
            touched,
            -self.alpha * (m / (1.0 - self.beta1))
            / (jnp.sqrt(v / (1.0 - self.beta2)) + self.epsilon), 0.0)
        return table + delta, {"m": m, "v": v}


def make_optimizer(name: str, learning_rate: float) -> SparseOptimizer:
    """Optimizer whitelist matching `/root/reference/cymf/bpr.pyx:65-66`."""
    if name == "adam":
        return Adam(alpha=learning_rate)
    if name == "adagrad":
        return AdaGrad(learning_rate)
    if name == "sgd":
        return Sgd(learning_rate)
    raise Exception(f"{name} is invalid.")
