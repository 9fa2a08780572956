"""Weighted Matrix Factorization / implicit ALS (Hu, Koren, Volinsky 2008).

Behavioural spec from `/root/reference/cymf/wmf.pyx`: per epoch, alternate
closed-form least-squares sweeps over users then items.  For each row r with
positive set P(r) over the other-side table Y:

    A = Y^T Y + wd*I + (c-1) * sum_{i in P(r)} y_i y_i^T
    b = c * sum_{i in P(r)} y_i
    row <- A^{-1} b          (zeros when P(r) is empty, `wmf.pyx:154-156`)

with confidence weight ``c`` (default 10, `wmf.pyx:46`).

Redesign: the per-row OpenMP loop with per-thread malloc + LAPACK
``dgesv`` (`wmf.pyx:150-174`) becomes degree-bucketed *batched* solves — the
Gramian is one matmul (psum-reduced across the mesh when Y is
row-sharded), rank-deg corrections are one batched einsum per chunk, and the
K x K systems are solved by batched Cholesky (LU optional, matching dgesv).
The reference's malloc leak on empty rows (`wmf.pyx:151-156`) has no
analogue here.
"""

from __future__ import annotations

import os
from typing import List

import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops.als import (AlsChunk, build_chunks, gramian, resolve_chol_solver,
                       wmf_chunk_solve, wmf_chunk_solve_woodbury)
from .base import MFTrainerBase, PersistenceMixin, as_csr


class WMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.WMF`` (`wmf.pyx:32-59`)."""

    def __init__(self, num_components: int = 20, weight_decay: float = 0.01,
                 weight: float = 10.0, chunk_size: int = 2048,
                 solver: str = "cholesky"):
        super().__init__(num_components)
        self.weight_decay = float(weight_decay)
        self.weight = float(weight)
        self.chunk_size = int(chunk_size)
        if solver not in ("cholesky", "lu"):
            raise ValueError("solver must be 'cholesky' or 'lu'")
        self.solver = solver

    def fit(self, X, num_epochs: int = 5, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = True, checkpoint_path=None,
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

        mesh = self.mesh
        Wd = self._pad_table(self.W)
        Hd = self._pad_table(self.H)
        self._state = {"W": Wd, "H": Hd}
        start_epoch = 0
        if resume and checkpoint_path is not None \
                and os.path.exists(checkpoint_path):
            from ..utils.checkpoint import load_checkpoint
            self._state, last_epoch, _ = load_checkpoint(
                checkpoint_path, self._state, rows=self._state_rows())
            start_epoch = last_epoch + 1

        Xt = X.T.tocsr()
        Xt.sort_indices()
        user_chunks = self._device_chunks(
            build_chunks(X, self.chunk_size, Wd.shape[0],
                         num_components=self.num_components))
        item_chunks = self._device_chunks(
            build_chunks(Xt, self.chunk_size, Hd.shape[0],
                         num_components=self.num_components))
        self._samples_per_epoch = X.nnz
        eye = jnp.eye(self.num_components, dtype=config.param_dtype())
        wd = self.weight_decay
        weight = jnp.asarray(self.weight, config.param_dtype())

        # Woodbury routing (`ops/als.py::wmf_chunk_solve_woodbury`):
        # auto routes chunks whose degree pad P is small next to K to the
        # P^3 Woodbury solve instead of the K^3 Cholesky, when K >= 128,
        # weight > 1, and weight_decay >= 1e-3 (the explicit f32 A0
        # inverse loses ~cond*eps digits; cond(A0) <= ~||YtY||/wd).  The
        # cap is P <= K/4 against the blocked Cholesky form and P <= K
        # against the XLA one.
        wb_mode = os.environ.get("CYMF_TPU_ALS_WOODBURY", "auto")
        if wb_mode not in ("auto", "off", "on"):
            raise ValueError("CYMF_TPU_ALS_WOODBURY must be auto|off|on")
        if wb_mode == "on" and self.weight <= 1.0:
            raise ValueError(
                "CYMF_TPU_ALS_WOODBURY=on requires weight > 1 (the "
                "Woodbury capacitance divides by weight - 1)")
        # resolve the CYMF_TPU_ALS_CHOL knob ONCE here so the explicit
        # solver name is a jit cache key (`ops/als.py::resolve_chol_solver`)
        solver_r = resolve_chol_solver(self.solver, self.num_components)
        wb_auto_cap = (self.num_components // 4
                       if solver_r.startswith("cholesky_blocked")
                       else self.num_components)
        wb_max_p = (0 if wb_mode == "off" or self.weight <= 1.0
                    else (1 << 30) if wb_mode == "on"
                    else wb_auto_cap
                    if self.weight_decay >= 1e-3
                    and self.num_components >= 128 else 0)
        self.woodbury_max_p_ = wb_max_p  # routing diagnostic

        if mesh.num_devices > 1:
            # explicit shard_map chunk solves: Gramian = local matmul +
            # psum, C/n systems per device, O(gathered-rows) exchange
            # (parallel/shard_step.py::sharded_wmf_chunk); small-P
            # chunks Woodbury-route at trace time
            from ..parallel.shard_step import sharded_wmf_chunk
            import functools as _ft

            @_ft.lru_cache(maxsize=None)
            def _chunk_fn():
                return sharded_wmf_chunk(mesh, self.weight,
                                         self.weight_decay,
                                         self.num_components, solver_r,
                                         wb_max_p)

            def half_sweep(target_key: str, source_key: str,
                           chunks: List[AlsChunk]):
                Y = self._state[source_key]
                T = self._state[target_key]
                fn = _chunk_fn()
                for ch in chunks:
                    T = fn(Y, T, ch.rows, ch.idx_pad, ch.valid)
                self._state[target_key] = T
        else:
            def half_sweep(target_key: str, source_key: str,
                           chunks: List[AlsChunk]):
                Y = self._state[source_key]
                A0 = gramian(Y) + wd * eye
                # LU factorization + triangular solves: no matmul, so no
                # TF32 path
                A0i = jnp.linalg.inv(A0) if any(
                    c.idx_pad.shape[1] <= wb_max_p for c in chunks) \
                    else None
                T = self._state[target_key]
                for ch in chunks:
                    if ch.idx_pad.shape[1] <= wb_max_p:
                        rows = wmf_chunk_solve_woodbury(
                            Y, A0i, ch.idx_pad, ch.valid, weight,
                            solver=solver_r)
                    else:
                        rows = wmf_chunk_solve(Y, A0, ch.idx_pad,
                                               ch.valid, weight,
                                               solver=solver_r)
                    T = T.at[ch.rows].set(rows, mode="drop",
                                          unique_indices=True)
                self._state[target_key] = T

        def epoch_fn(epoch):
            half_sweep("W", "H", user_chunks)   # wmf.pyx:111
            half_sweep("H", "W", item_chunks)   # wmf.pyx:112

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = np.array(snap[0]), np.array(snap[1])

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose, ncols=100, checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         start_epoch=start_epoch)
        self._finalize_fit()

    def _device_chunks(self, chunks: List[AlsChunk]) -> List[AlsChunk]:
        from ..ops.als import place_device_chunks
        return place_device_chunks(self.mesh, chunks)
