"""Bayesian Personalized Ranking (Rendle et al. 2009) — JAX trainer.

Behavioural spec from `/root/reference/cymf/bpr.pyx` + `model.pyx:37-87`:
per observed (user, positive) interaction, draw one uniform negative, skip it
if it is a known positive, and descend the pairwise loss

    L = -log(sigmoid(w_u . (h_i - h_j))) + wd * (|w_u|^2 + |h_i|^2 + |h_j|^2)

with gradients exactly as in `model.pyx:80-87` (weight decay folded into the
gradient, no factor 2).

Redesign for an accelerator (not a port):

* The Hogwild ``prange`` over single samples (`bpr.pyx:162`) becomes a
  ``lax.scan`` over minibatches inside one jitted epoch: each step gathers
  the touched embedding rows, computes the batch of pairwise losses,
  combines duplicate rows by segment-sum, and applies one synchronous
  sparse optimizer update (`cymf_tpu.optim`).  One compile per fit; zero
  per-step dispatch overhead.
* Negative sampling runs inside jit with counter-based ``jax.random``;
  collisions with known positives are *masked out* (weight 0), the
  fixed-shape equivalent of the reference's skip (`bpr.pyx:166-167`).
  Membership tests probe a two-level pair hash set (`ops/hashset.py`).
* Tables are row-sharded over the device mesh; batches are sharded over the
  same axis.  XLA inserts the gather/scatter collectives.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hashset import build_pair_hashset, hashset_contains
from ..optim import make_optimizer
from .base import MFTrainerBase, PersistenceMixin, as_csr


PAD_USER = np.int32(2**31 - 1)  # padding sentinel: sorts last, OOB-dropped


def choose_update_mode(mode: str, batch_rows: int, table_rows: int) -> str:
    """'auto' resolves to dense when the batch covers enough of the table
    that a full-table pass is cheaper than sorted row-scatters."""
    if mode != "auto":
        return mode
    return "dense" if batch_rows * 16 >= table_rows else "sparse"


@functools.lru_cache(maxsize=16)
def _sharded_epoch_jit(mesh, opt_name: str, lr: float, wd: float,
                       num_users: int, num_items: int):
    """Cached (optimizer, jitted shard_map epoch) per (mesh, config) —
    the multi-device analogue of :func:`_bpr_epoch_jit`; repeated fits
    (warm starts, HPO sweeps) reuse the compiled executable."""
    from ..parallel.shard_step import sharded_bpr_epoch
    opt = make_optimizer(opt_name, lr)
    return opt, sharded_bpr_epoch(mesh, opt, wd, num_users, num_items)


@functools.lru_cache(maxsize=64)
def _bpr_epoch_jit(opt_name: str, lr: float, wd: float, num_users: int,
                   num_items: int, mode: str):
    """Cached (optimizer, jitted epoch) per static config — repeated fits
    (warm starts, HPO sweeps) reuse the compiled executable instead of
    recompiling per call."""
    opt = make_optimizer(opt_name, lr)
    fn = jax.jit(
        functools.partial(_bpr_epoch, optimizer=opt, weight_decay=wd,
                          num_users=num_users, num_items=num_items,
                          update_mode=mode, u_presorted=True),
        donate_argnums=(0, 1, 2, 3))
    return opt, fn


def _bpr_epoch(W, H, opt_w, opt_h, u_steps, i_steps, hs, n_valid, key, *,
               optimizer, weight_decay, num_users, num_items,
               update_mode="dense", u_presorted=False):
    """One epoch: scan over minibatch steps. Returns new state + mean loss.

    ``update_mode``:
      * "dense"  — scatter-add per-sample gradients into a table-shaped
        buffer, then one masked full-table optimizer pass.  Duplicates
        combine natively (no sort).  Fastest when the batch touches a
        sizable fraction of the table.
      * "sparse" — sort-dedup + row-scatter updates; O(batch) memory
        traffic, for very large catalogs.
    Both produce identical updates (one step per touched row with the
    summed gradient).
    """
    S, B = u_steps.shape
    wd = jnp.asarray(weight_decay, W.dtype)

    def step(carry, xs):
        W, H, opt_w, opt_h, loss_acc = carry
        u, i, sidx = xs
        skey = jax.random.fold_in(key, sidx)
        j = jax.random.randint(skey, (B,), 0, num_items, dtype=u.dtype)
        # padding samples carry the PAD_USER sentinel (sorts last, survives
        # the in-batch user sort; OOB scatters are dropped by XLA)
        in_data = u < num_users
        collide = hashset_contains(hs, u, j)
        mask = in_data & ~collide
        mf = mask.astype(W.dtype)[:, None]

        wu, hi, hj = W[u], H[i], H[j]
        x = jnp.sum(wu * (hi - hj), axis=1, keepdims=True)
        sig = jax.nn.sigmoid(-x)  # 1/(1+e^x), cf. model.pyx:78
        # gradients per model.pyx:81-83 (decay inside the gradient)
        g_wu = -(sig * (hi - hj) - wd * wu) * mf
        g_hi = -(sig * wu - wd * hi) * mf
        g_hj = -(-sig * wu - wd * hj) * mf
        l2 = (jnp.sum(jnp.square(wu), axis=1)
              + jnp.sum(jnp.square(hi), axis=1)
              + jnp.sum(jnp.square(hj), axis=1))
        loss = (-jax.nn.log_sigmoid(x[:, 0]) + wd * l2) * mf[:, 0]

        if update_mode == "dense":
            # u_presorted: the trainer sorts each batch by user on the host
            # (order within a synchronous batch is semantically irrelevant)
            W, opt_w = optimizer.update_dense(W, opt_w, [(u, g_wu)],
                                              rows_sorted=u_presorted)
            H, opt_h = optimizer.update_dense(
                H, opt_h, [(i, g_hi), (j, g_hj)])
        else:
            W, opt_w = optimizer.update_rows(W, opt_w, u, g_wu)
            H, opt_h = optimizer.update_rows(
                H, opt_h, jnp.concatenate([i, j]),
                jnp.concatenate([g_hi, g_hj]))
        return (W, H, opt_w, opt_h, loss_acc + jnp.sum(loss)), None

    init = (W, H, opt_w, opt_h, jnp.zeros((), W.dtype))
    (W, H, opt_w, opt_h, loss), _ = jax.lax.scan(
        step, init, (u_steps, i_steps, jnp.arange(S)))
    return W, H, opt_w, opt_h, loss / jnp.maximum(n_valid, 1).astype(W.dtype)


class BPR(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.BPR`` (`bpr.pyx:37-68`).

    Vectorized synchronous-minibatch epochs (``lax.scan``), single-device
    or row-sharded over the mesh (`parallel/shard_step.py`)."""

    def __init__(self, num_components: int = 20, learning_rate: float = 0.001,
                 optimizer: str = "adam", weight_decay: float = 0.01,
                 batch_size: int = 1024, update_mode: str = "auto"):
        super().__init__(num_components)
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
            verbose: bool = True, seed: int = 1234,
            checkpoint_path=None, checkpoint_every: int = 1,
            resume: bool = False):
        """Train; signature parity with `bpr.pyx:68`.

        ``num_threads`` is accepted for compatibility and ignored (SPMD over
        the mesh replaces Hogwild threads).  ``seed`` drives the negative
        sampler, matching the role of the reference's ``UniformGenerator``
        seed (`bpr.pyx:148`).  ``checkpoint_path`` enables periodic
        state checkpoints; ``resume=True`` continues from the checkpoint's
        epoch with tables AND optimizer state restored.
        """
        X = as_csr(X)
        self.valid_evaluator = valid_evaluator
        self.valid_dcg = -np.inf
        self.early_stopping = early_stopping
        if early_stopping and valid_evaluator is None:
            raise ValueError()

        U, I = X.shape
        self._num_users, self._num_items = U, I
        self._ensure_tables(U, I)

        # same global-RandomState stream as sklearn.utils.shuffle
        users, positives = X.nonzero()
        perm = np.random.permutation(len(users))
        users = users[perm].astype(np.int32)
        positives = positives[perm].astype(np.int32)
        self._samples_per_epoch = N = len(users)
        mesh = self.mesh
        B = mesh.pad_rows(min(self.batch_size, max(N, mesh.num_devices)))
        S = max(1, -(-N // B))
        pad = S * B - N
        if pad:
            users = np.concatenate(
                [users, np.full(pad, PAD_USER, np.int32)])
            positives = np.concatenate([positives, np.zeros(pad, np.int32)])

        # sort each batch by user: enables indices_are_sorted on the W
        # scatter without changing synchronous semantics
        u2 = users.reshape(S, B)
        i2 = positives.reshape(S, B)
        order = np.argsort(u2, axis=1, kind="stable")
        u2 = np.take_along_axis(u2, order, axis=1)
        i2 = np.take_along_axis(i2, order, axis=1)
        u_steps = jax.device_put(u2, mesh.batch2d())
        i_steps = jax.device_put(i2, mesh.batch2d())
        coo = X.tocoo()
        hs = build_pair_hashset(coo.row, coo.col)
        hs = jax.tree_util.tree_map(mesh.put_replicated, hs)

        Wd = self._pad_table(self.W)
        Hd = self._pad_table(self.H)
        if mesh.num_devices > 1 and self.update_mode == "sparse":
            import warnings
            warnings.warn(
                "update_mode='sparse' applies to the single-device path "
                "only; the shard_map epoch uses dense masked updates "
                "(each shard's update buffer is its table shard — "
                "already O(rows/devices) memory)", stacklevel=2)
        if mesh.num_devices > 1:
            # explicit shard_map path: row-sharded tables, sharded batch,
            # hand-placed O(batch) collectives — compute partitioning is
            # guaranteed by construction (parallel/shard_step.py) and the
            # negative stream is bitwise-identical to the 1-device path.
            opt, epoch_jit = _sharded_epoch_jit(
                mesh, self.optimizer, self.learning_rate,
                self.weight_decay, U, I)
        else:
            mode = choose_update_mode(self.update_mode, 3 * B,
                                      Wd.shape[0] + Hd.shape[0])
            opt, epoch_jit = _bpr_epoch_jit(
                self.optimizer, self.learning_rate, self.weight_decay,
                U, I, mode)
        base_key = jax.random.PRNGKey(seed)
        self._state = {"W": Wd, "H": Hd, "ow": opt.init(Wd),
                       "oh": opt.init(Hd)}
        self.last_loss = None
        self._last_loss_dev = None

        start_epoch = 0
        if resume and checkpoint_path is not None \
                and os.path.exists(checkpoint_path):
            from ..utils.checkpoint import load_checkpoint
            self._state, last_epoch, _ = load_checkpoint(
                checkpoint_path, self._state, rows=self._state_rows())
            start_epoch = last_epoch + 1

        def epoch_fn(epoch):
            st = self._state
            st["W"], st["H"], st["ow"], st["oh"], self._last_loss_dev = \
                epoch_jit(st["W"], st["H"], st["ow"], st["oh"],
                          u_steps, i_steps, hs,
                          jnp.asarray(N, jnp.int32),
                          jax.random.fold_in(base_key, epoch))

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = np.array(snap[0]), np.array(snap[1])

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose, checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         start_epoch=start_epoch)
        if self._last_loss_dev is not None:
            self.last_loss = float(jax.device_get(self._last_loss_dev))
        self._finalize_fit()
