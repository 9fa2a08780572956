"""Shared trainer machinery: input coercion, init, early stopping.

Replicates the sklearn-style estimator contract of the reference trainers
(`/root/reference/cymf/bpr.pyx:50-68` and friends): ``Model(...)`` holds
hyperparameters, ``fit(X, num_epochs, num_threads, valid_evaluator,
early_stopping, verbose)`` trains, learned factors are exposed as numpy
``model.W`` / ``model.H`` and warm-start when pre-set.

``num_threads`` is accepted for API compatibility but has no effect: the
OpenMP Hogwild thread pool is replaced by synchronous SPMD batches over the
device mesh (SURVEY.md §2 "Parallelism strategies").
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
from scipy import sparse

try:
    from tqdm import tqdm as _tqdm
except ImportError:  # optional: a plain progress line stands in
    _tqdm = None

from .. import config
from ..parallel.mesh import MeshContext, current_mesh, fetch_to_host


class _PlainProgress:
    """tqdm's bar interface, printing one line per update to stderr."""

    def __init__(self, total: int, initial: int = 0, disable: bool = False):
        self.total, self.n, self.disable, self.desc = (total, initial,
                                                       disable, "")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_description(self, desc: str) -> None:
        self.desc = desc

    def update(self, n: int = 1) -> None:
        self.n += n
        if not self.disable:
            print(f"{self.desc} [{self.n}/{self.total}]", file=sys.stderr,
                  flush=True)


def progress(total: int, initial: int = 0, disable: bool = False,
             ncols: int = 100):
    """Epoch progress bar: tqdm when installed, else a plain line."""
    if _tqdm is None:
        return _PlainProgress(total, initial, disable)
    return _tqdm(total=total, leave=True, ncols=ncols, initial=initial,
                 disable=disable)


def as_csr(X) -> sparse.csr_matrix:
    """Input coercion per `/root/reference/cymf/bpr.pyx:81-87`."""
    if X is None:
        raise ValueError()
    if sparse.issparse(X):
        X = X.tocsr()
    elif isinstance(X, np.ndarray):
        X = sparse.csr_matrix(X)
    else:
        raise ValueError()
    X = X.astype(np.float64)
    X.sort_indices()
    return X


def uniform_init(shape, scale_div: float, low=-0.1, high=0.1,
                 seed: Optional[int] = None) -> np.ndarray:
    """U(low, high)/num_components init (`bpr.pyx:97-101`).

    The reference seeds numpy with 4321 immediately before drawing W (and
    draws H from the advanced state); callers pass ``seed=4321`` for W and
    ``seed=None`` for H to replicate the stream.
    """
    if seed is not None:
        np.random.seed(seed)
    return np.random.uniform(low=low, high=high, size=shape) / scale_div


class EarlyStopper:
    """Exact early-stopping state machine of the reference trainers.

    From `/root/reference/cymf/bpr.pyx:173-183`: track best validation DCG@5;
    on a non-improving epoch increment a counter, breaking once the counter
    exceeds 10; on improvement reset the counter and snapshot best weights.
    Best weights are restored only when ``early_stopping`` is on
    (`bpr.pyx:188-190`).
    """

    def __init__(self, early_stopping: bool):
        self.early_stopping = early_stopping
        self.best_dcg = -np.inf
        self.count = 0
        self.best_snapshot = None

    def update(self, dcg: float, snapshot_fn) -> bool:
        """Returns True if training should stop now."""
        if self.best_dcg > dcg:
            if self.early_stopping and self.count > 10:
                return True
            if self.early_stopping:
                self.count += 1
        else:
            self.count = 0
            self.best_dcg = dcg
            # Best weights are only ever restored under early_stopping
            # (`bpr.pyx:188-190`) — without it, snapshotting would pull the
            # full tables device->host every improving epoch for nothing.
            if self.early_stopping:
                self.best_snapshot = snapshot_fn()
        return False


class MFTrainerBase:
    """Base for the two-table (W: users, H: items) trainers.

    ``model.W`` / ``model.H`` are numpy views of the learned factors
    (`bpr.pyx:46-47`).  During ``fit`` the live tables are device arrays in
    ``self._state``; the properties slice off the sharding pad and pull to
    host lazily, so epochs that skip validation never touch the host.
    """

    def __init__(self, num_components: int):
        self.num_components = int(num_components)
        self._W_host: Optional[np.ndarray] = None
        self._H_host: Optional[np.ndarray] = None
        self._state = None  # dict with device arrays "W", "H" during fit
        self._num_users = 0
        self._num_items = 0
        self.valid_evaluator = None
        self.valid_dcg = -np.inf
        self.count = 0
        self.early_stopping = False

    @property
    def W(self):
        if self._state is not None:
            return fetch_to_host(self._state["W"])[:self._num_users]
        return self._W_host

    @W.setter
    def W(self, value):
        self._drop_device_state()
        self._W_host = None if value is None else np.asarray(value)

    @property
    def H(self):
        if self._state is not None:
            return fetch_to_host(self._state["H"])[:self._num_items]
        return self._H_host

    @H.setter
    def H(self, value):
        self._drop_device_state()
        self._H_host = None if value is None else np.asarray(value)

    def _drop_device_state(self):
        """Setting a table by hand invalidates device state; keep both host
        copies first so the untouched table survives."""
        if self._state is not None:
            self._W_host = fetch_to_host(self._state["W"])[:self._num_users]
            self._H_host = fetch_to_host(self._state["H"])[:self._num_items]
            self._state = None

    def _finalize_fit(self):
        """Materialize learned tables to host and drop device state."""
        if self._state is not None:
            w = fetch_to_host(self._state["W"])[:self._num_users]
            h = fetch_to_host(self._state["H"])[:self._num_items]
            self._state = None
            self._W_host, self._H_host = w, h

    # -- init ---------------------------------------------------------------
    def _ensure_tables(self, num_rows_w: int, num_rows_h: int) -> None:
        """Lazy init W,H ~ U(-0.1, 0.1)/K with np.random.seed(4321) before W
        only (`bpr.pyx:97-101`); existing tables are kept (warm start)."""
        K = self.num_components
        if self.W is None:
            self.W = uniform_init((num_rows_w, K), K, seed=4321)
        if self.H is None:
            self.H = uniform_init((num_rows_h, K), K)

    def _state_rows(self) -> dict:
        """Real row count of each ``self._state`` entry (the rest is mesh
        padding): user-side tables and their optimizer state hold
        ``num_users`` rows, item-side ones (and ExpoMF's ``mu``)
        ``num_items``.  Checkpoints record it; resuming checks it."""
        U, I = self._num_users, self._num_items
        side = {"W": U, "ow": U, "H": I, "oh": I, "mu": I}
        return {k: side[k] for k in self._state}

    # -- mesh ---------------------------------------------------------------
    @property
    def mesh(self) -> MeshContext:
        return current_mesh()

    def _pad_table(self, T: np.ndarray):
        """Pad rows to a mesh-divisible count and place row-sharded."""
        mesh = self.mesh
        n = T.shape[0]
        n_pad = mesh.pad_rows(n)
        if n_pad != n:
            T = np.concatenate(
                [T, np.zeros((n_pad - n,) + T.shape[1:], T.dtype)], axis=0)
        import jax.numpy as jnp
        return mesh.put_table(jnp.asarray(T, dtype=config.param_dtype()))

    # -- fit loop -----------------------------------------------------------
    def _run_epochs(self, num_epochs: int, epoch_fn, snapshot_fn, restore_fn,
                    verbose: bool, desc_extra_fn=None, ncols: int = 120,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 1, start_epoch: int = 0):
        """Run ``epoch_fn(epoch) -> loss`` with validation/early stopping.

        Mirrors the loop at `bpr.pyx:160-190`: per-epoch validation via
        ``valid_evaluator.evaluate(W, H)["DCG@5"]``, stop after >10
        consecutive non-improving epochs, restore best weights at the end.

        When ``checkpoint_path`` is set, the live device state is written
        every ``checkpoint_every`` epochs (atomic npz; see
        ``cymf_tpu.utils.checkpoint``) so a killed run can resume.  The
        disk write runs on a background thread (only the device->host
        snapshot blocks the loop); the writer is flushed before ``fit``
        returns, so the file is complete when training is.
        """
        from ..utils.checkpoint import AsyncCheckpointer
        from ..utils.profiling import Throughput
        stopper = EarlyStopper(self.early_stopping)
        ckpt = AsyncCheckpointer() if checkpoint_path else None
        valid_dcg = None
        thr = Throughput()
        samples_per_epoch = getattr(self, "_samples_per_epoch", 0)
        thr.tick(0)
        with progress(num_epochs, initial=start_epoch, disable=not verbose,
                      ncols=ncols) as bar:
            for epoch in range(start_epoch, num_epochs):
                epoch_fn(epoch)
                thr.tick(samples_per_epoch)
                if ckpt and (epoch + 1) % checkpoint_every == 0:
                    ckpt.save(checkpoint_path, self._state, epoch,
                              rows=self._state_rows())
                if self.valid_evaluator:
                    valid_dcg = self.valid_evaluator.evaluate(
                        self.W, self.H)["DCG@5"]
                    if stopper.update(valid_dcg, snapshot_fn):
                        break
                    self.valid_dcg = stopper.best_dcg
                rate = (f", {thr.format()}" if samples_per_epoch
                        and thr.rate else "")
                bar.set_description(
                    f"EPOCH={epoch + 1:{len(str(num_epochs))}}"
                    + (f", DCG@5={np.round(valid_dcg, 3)}"
                       if self.valid_evaluator else "")
                    + rate
                    + (desc_extra_fn() if desc_extra_fn else ""))
                bar.update(1)
        if ckpt:
            ckpt.wait()
        if self.valid_evaluator and self.early_stopping \
                and stopper.best_snapshot is not None:
            restore_fn(stopper.best_snapshot)


def _model_to_arrays(model) -> dict:
    arrays = {"W": model.W, "H": model.H,
              "num_components": np.asarray(model.num_components)}
    for name in ("learning_rate", "weight_decay", "weight", "clip_value",
                 "lam_y"):
        if hasattr(model, name):
            arrays[f"hyper_{name}"] = np.asarray(getattr(model, name))
    return arrays


class PersistenceMixin:
    """``model.save(path)`` / ``Model.load(path)``: persist learned factors
    + hyperparameters as a single npz (the reference has no persistence
    beyond GloVe's text export — SURVEY.md §5)."""

    def save(self, path: str) -> None:
        if self.W is None or self.H is None:
            raise ValueError("model has no learned factors to save")
        d = _model_to_arrays(self)
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        np.savez(path, **d)

    @classmethod
    def load(cls, path: str):
        with np.load(path) as z:
            kwargs = {"num_components": int(z["num_components"])}
            for k in z.files:
                if k.startswith("hyper_"):
                    kwargs[k[len("hyper_"):]] = float(z[k])
            model = cls(**kwargs)
            model.W = z["W"]
            model.H = z["H"]
            model._num_users = z["W"].shape[0]
            model._num_items = z["H"].shape[0]
        return model
