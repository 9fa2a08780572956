"""Relevance Matrix Factorization (Saito et al. 2019) — JAX trainer.

Behavioural spec from `/root/reference/cymf/relmf.pyx` + `model.pyx:89-142`:
each epoch draws ``N = U * I`` uniform random (user, item) cells — positives
AND negatives — and descends the propensity-clipped pointwise loss

    w      = r / max(p_i, M)                      (clip value M, ctor default 0.1)
    L      = w * (1 - s)^2 + (1 - w) * s^2 + wd * (|w_u|^2 + |h_i|^2)
    s      = w_u . h_i                            (raw dot, no sigmoid)

with gradients exactly as `model.pyx:130-139` (note the reference *adds*
the weight-decay term here, opposite sign convention vs BPR — replicated).
Propensities p_i = max(mean_u X[:, i] / max_mean, 1e-5)^0.5
(`relmf.pyx:88`).

Redesign: the reference densifies X (`relmf.pyx:79-81`) and draws
one flat index ``r`` with ``u = r / I, i = r % I`` from a shared racy
mt19937 (`relmf.pyx:143-148`); here cells are drawn inside jit with
counter-based ``jax.random`` (independent u, i draws — the same uniform
distribution over cells) and the label is read from CSR by vectorized binary
search — X is never densified, so ML-20M-scale matrices stream fine.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops.hashset import build_pair_hashset, hashset_contains
from ..ops.segment import csr_lookup
from ..optim import make_optimizer
from .base import MFTrainerBase, PersistenceMixin, as_csr


_CHUNK_STEPS = 2048  # max scan length per device call (see _relmf_epoch)


@functools.lru_cache(maxsize=16)
def _sharded_relmf_epoch_jit(mesh, opt_name: str, lr: float, wd: float,
                             clip: float, num_users: int, num_items: int,
                             num_steps: int, batch_size: int, binary: bool):
    """Cached (optimizer, jitted shard_map epoch chunk) — the multi-device
    analogue of :func:`_relmf_epoch_jit` with identical call contract."""
    from ..parallel.shard_step import sharded_relmf_epoch
    opt = make_optimizer(opt_name, lr)
    return opt, sharded_relmf_epoch(mesh, opt, wd, clip, num_users,
                                    num_items, num_steps, batch_size,
                                    binary)


@functools.lru_cache(maxsize=64)
def _relmf_epoch_jit(opt_name: str, lr: float, wd: float, clip: float,
                     num_users: int, num_items: int, num_steps: int,
                     batch_size: int, mode: str, binary: bool):
    opt = make_optimizer(opt_name, lr)
    fn = jax.jit(
        functools.partial(_relmf_epoch, optimizer=opt, weight_decay=wd,
                          clip_value=clip, num_users=num_users,
                          num_items=num_items, num_steps=num_steps,
                          batch_size=batch_size, update_mode=mode,
                          binary_labels=binary),
        donate_argnums=(0, 1, 2, 3))
    return opt, fn


def _relmf_epoch(W, H, opt_w, opt_h, label_src, props, key, step0, *,
                 optimizer, weight_decay, clip_value, num_users, num_items,
                 num_steps, batch_size, update_mode="dense",
                 binary_labels=False):
    """One CHUNK of ``num_steps`` sampled-cell SGD steps starting at step
    index ``step0`` (a traced scalar — chunk offsets reuse one compiled
    executable).  Step ``sidx`` always folds the same key regardless of
    chunking, so a chunked epoch is bitwise-identical to a monolithic
    one; epochs are chunked so that a single device call stays short at
    ML-20M scale (3.7e9 cells per epoch).  Returns the SUM of per-sample
    losses — callers normalize over the full epoch."""
    wd = jnp.asarray(weight_decay, W.dtype)
    M = jnp.asarray(clip_value, W.dtype)

    def step(carry, sidx):
        W, H, opt_w, opt_h, loss_acc = carry
        skey = jax.random.fold_in(key, sidx)
        ku, ki = jax.random.split(skey)
        u = jax.random.randint(ku, (batch_size,), 0, num_users,
                               dtype=config.index_dtype)
        i = jax.random.randint(ki, (batch_size,), 0, num_items,
                               dtype=config.index_dtype)
        if binary_labels:
            # binarized matrices (the standard pipeline): the label is pure
            # membership -> 2-gather hash-set probe instead of a 32-round
            # CSR binary search (the RelMF hot-path bottleneck)
            r = hashset_contains(label_src, u, i).astype(W.dtype)
        else:
            indptr, indices, data = label_src
            _, r = csr_lookup(indptr, indices, data, u, i)
        p = props[i, 0]  # (I, 1) column layout: row gather, not lane gather
        w = r / jnp.maximum(p, M)

        wu, hi = W[u], H[i]
        s = jnp.sum(wu * hi, axis=1, keepdims=True)
        wcol = w[:, None]
        # gradients per model.pyx:130-139 (decay ADDED, reference sign quirk)
        g_w = -(wcol * (1.0 - s) * hi + (1.0 - wcol) * (0.0 - s) * hi) \
            + wd * wu
        g_h = -(wcol * (1.0 - s) * wu + (1.0 - wcol) * (0.0 - s) * wu) \
            + wd * hi
        l2 = (jnp.sum(jnp.square(wu), axis=1)
              + jnp.sum(jnp.square(hi), axis=1))
        loss = (w * jnp.square(1.0 - s[:, 0])
                + (1.0 - w) * jnp.square(s[:, 0]) + wd * l2)

        if update_mode == "dense":
            W, opt_w = optimizer.update_dense(W, opt_w, [(u, g_w)])
            H, opt_h = optimizer.update_dense(H, opt_h, [(i, g_h)])
        else:
            W, opt_w = optimizer.update_rows(W, opt_w, u, g_w)
            H, opt_h = optimizer.update_rows(H, opt_h, i, g_h)
        return (W, H, opt_w, opt_h, loss_acc + jnp.sum(loss)), None

    init = (W, H, opt_w, opt_h, jnp.zeros((), W.dtype))
    (W, H, opt_w, opt_h, loss), _ = jax.lax.scan(
        step, init, step0 + jnp.arange(num_steps))
    return W, H, opt_w, opt_h, loss


class RelMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.RelMF`` (`relmf.pyx:37-67`)."""

    def __init__(self, num_components: int = 20, clip_value: float = 0.1,
                 learning_rate: float = 0.001, optimizer: str = "adam",
                 weight_decay: float = 0.01, batch_size: int = 8192,
                 update_mode: str = "auto"):
        super().__init__(num_components)
        self.clip_value = float(clip_value)
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer
        self.weight_decay = float(weight_decay)
        self.batch_size = int(batch_size)
        if update_mode not in ("auto", "dense", "sparse"):
            raise ValueError("update_mode must be auto|dense|sparse")
        self.update_mode = update_mode
        if self.optimizer not in ("sgd", "adagrad", "adam"):
            raise Exception(f"{self.optimizer} is invalid.")

    def fit(self, X, num_epochs: int = 10, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = False, seed: int = 1234, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        X = as_csr(X)
        self.valid_evaluator = valid_evaluator
        self.valid_dcg = -np.inf
        self.early_stopping = early_stopping
        if early_stopping and valid_evaluator is None:
            raise ValueError()

        U, I = X.shape
        self._num_users, self._num_items = U, I
        self._ensure_tables(U, I)

        # propensities per relmf.pyx:88 (column means of the full matrix)
        col_mean = np.asarray(X.mean(axis=0)).flatten()
        props = np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5

        mesh = self.mesh
        put = mesh.put_replicated
        binary = bool(X.nnz == 0 or np.all(X.data == 1.0))
        if binary:
            coo = X.tocoo()
            label_src = jax.tree_util.tree_map(
                put, build_pair_hashset(coo.row, coo.col))
        else:
            label_src = (put(jnp.asarray(X.indptr.astype(np.int32))),
                         put(jnp.asarray(X.indices.astype(np.int32))),
                         put(jnp.asarray(X.data,
                                         dtype=config.param_dtype())))
        props_d = put(jnp.asarray(props[:, None],
                                  dtype=config.param_dtype()))

        Wd = self._pad_table(self.W)
        Hd = self._pad_table(self.H)
        B = mesh.pad_rows(self.batch_size)
        if B != self.batch_size:
            import warnings
            warnings.warn(
                f"batch_size={self.batch_size} padded to {B} (multiple of "
                f"{mesh.num_devices} devices): the drawn cell stream and "
                "samples_per_epoch differ from a device count where no "
                "padding is needed", stacklevel=2)
        num_steps = max(1, -(-(U * I) // B))  # N = U*I samples per epoch
        self._samples_per_epoch = num_steps * B
        from .bpr import choose_update_mode
        mode = choose_update_mode(self.update_mode, 2 * B,
                                  Wd.shape[0] + Hd.shape[0])
        # chunk the epoch into scans of <= _CHUNK_STEPS (exact partition:
        # one compiled chunk executable + at most one remainder size);
        # chunking is RNG-transparent — see _relmf_epoch
        ch = min(num_steps, _CHUNK_STEPS)
        n_full, rem = divmod(num_steps, ch)
        if mesh.num_devices > 1:
            # explicit shard_map chunks: row-sharded tables, sharded cell
            # batches, O(batch) collectives, bitwise-identical cell stream
            # (parallel/shard_step.py::sharded_relmf_epoch)
            def maker(steps):
                return _sharded_relmf_epoch_jit(
                    mesh, self.optimizer, self.learning_rate,
                    self.weight_decay, self.clip_value, U, I, steps, B,
                    binary)
        else:
            def maker(steps):
                return _relmf_epoch_jit(
                    self.optimizer, self.learning_rate, self.weight_decay,
                    self.clip_value, U, I, steps, B, mode, binary)
        opt, chunk_jit = maker(ch)
        parts = [(chunk_jit, ch)] * n_full
        if rem:
            parts.append((maker(rem)[1], rem))
        self._state = {"W": Wd, "H": Hd, "ow": opt.init(Wd),
                       "oh": opt.init(Hd)}
        # resume AFTER _state exists, so the checkpointed pytree actually
        # lands in the live state
        start_epoch = 0
        if resume and checkpoint_path is not None \
                and os.path.exists(checkpoint_path):
            from ..utils.checkpoint import load_checkpoint
            self._state, last_epoch, _ = load_checkpoint(
                checkpoint_path, self._state, rows=self._state_rows())
            start_epoch = last_epoch + 1
        base_key = jax.random.PRNGKey(seed)
        self._last_loss_dev = None

        total = jnp.asarray(num_steps * B, config.param_dtype())

        def epoch_fn(epoch):
            st = self._state
            key = jax.random.fold_in(base_key, epoch)
            loss = jnp.zeros((), config.param_dtype())
            off = 0
            for fn, n in parts:
                st["W"], st["H"], st["ow"], st["oh"], l = fn(
                    st["W"], st["H"], st["ow"], st["oh"], label_src,
                    props_d, key, jnp.asarray(off, jnp.int32))
                loss = loss + l
                off += n
            self._last_loss_dev = loss / total

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = np.array(snap[0]), np.array(snap[1])

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose, ncols=100, checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         start_epoch=start_epoch)
        if self._last_loss_dev is not None:
            self.last_loss = float(jax.device_get(self._last_loss_dev))
        self._finalize_fit()
