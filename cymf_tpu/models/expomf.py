"""Exposure Matrix Factorization (Liang et al. 2016) — JAX trainer.

Behavioural spec from `/root/reference/cymf/expomf.pyx`: EM with
exposure-weighted ALS.  Per epoch, with epoch-start factors (W0, H0):

E-step (`expomf.pyx:134-137`):
    n_ui  = prefactor * exp(-lam_y * (W0 H0^T)_{ui}^2 / 2)
    E_ui  = (n_ui + 1e-8) / (n_ui + 1e-8 + (1 - mu_i) / mu_i);  E = 1 at
    observed cells.
M-step (`expomf.pyx:165-204`): per user u,
    A = (wd / lam_y) I + lam_y * sum_{ALL items j} E_uj h_j h_j^T
    b = lam_y * sum_{observed j} h_j          (E = 1 there)
then the symmetric item sweep with Y = the *updated* W but the *epoch-start*
Exposure; finally mu_i = (a1 + sum_u E_ui - 1) / (a1 + a2 + U - 2) with a
Beta(1, 1) prior (`expomf.pyx:113-114,142`).

Redesign: the dense U x I Exposure matrix (`expomf.pyx:111,134`)
is never materialized — each user/item chunk recomputes its E block from
(W0, H0) (one matmul), folds it straight into the weighted Gramian
``Y^T diag(E_row) Y`` (a batched einsum — replacing the O(rows * I * K^2)
scalar triple loop at `expomf.pyx:196-199`), and solves by batched Cholesky.
Column sums of E for the mu update are accumulated across user chunks.

Fixed reference defect (SURVEY.md §7): `expomf.pyx:134` computes the
Gaussian prefactor as ``sqrt(lam_y / 2.0*M_PI)`` which by precedence is
``sqrt(lam_y * pi / 2)``; the paper's pdf prefactor is
``sqrt(lam_y / (2*pi))``, used here (override with ``prefactor=`` to
replicate the reference exactly).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops.als import HIGHEST, AlsChunk, build_chunks, get_solver
from .base import MFTrainerBase, PersistenceMixin, as_csr


@functools.partial(jax.jit, static_argnames=("solver", "num_real_rows"))
def _expomf_chunk(E_src, E_other, Y, mu_term, rows, idx_pad, valid,
                  lam_y, ridge_eye, prefactor, *, solver: str,
                  num_real_rows: int):
    """Solve one chunk of rows (users or items — symmetric by arguments).

    Args:
      E_src: [R, K] epoch-start factors for this side (rows gathered).
      E_other: [Co, K] epoch-start factors for the other side (E columns).
      Y: [Co, K] the other-side table used in the normal equations (for the
        item sweep this is the *updated* W, while E still uses W0).
      mu_term: [Co] value of (1-mu)/mu per other-side column for the user
        sweep, or [R]-gathered scalar per row for the item sweep — passed
        already broadcast to [C, Co] by the caller? No: passed as [Co] or
        [C, 1]; broadcasting handles both.
      rows: int32[C] target row ids (sentinel >= num_real_rows -> dropped).
      idx_pad/valid: padded observed indices for b.

    Returns (new_rows [C, K], e_colsum [Co]) where e_colsum sums E over the
    *real* rows of this chunk (for the mu update on the user sweep).
    """
    n_pad_rows = E_src.shape[0]
    crows = jnp.clip(rows, 0, n_pad_rows - 1)
    S = jnp.matmul(E_src[crows], E_other.T,
                   preferred_element_type=jnp.float32,
                   precision=HIGHEST)                       # [C, Co]
    n = prefactor * jnp.exp(-lam_y * jnp.square(S) / 2.0)
    post = (n + 1e-8) / (n + 1e-8 + mu_term)
    # observed cells -> exposure 1 (expomf.pyx:135-137)
    C = rows.shape[0]
    obs_idx = jnp.where(valid, idx_pad, E_other.shape[0])
    obs = jnp.zeros(S.shape, bool).at[
        jnp.arange(C)[:, None], obs_idx].set(True, mode="drop")
    E = jnp.where(obs, 1.0, post)
    row_live = (rows < num_real_rows)
    e_colsum = jnp.sum(E * row_live[:, None], axis=0)

    # normal equations: A = ridge + lam_y * Y^T diag(E_row) Y (batched)
    A = ridge_eye[None] + lam_y * jnp.einsum(
        "ci,ik,il->ckl", E, Y, Y, preferred_element_type=jnp.float32,
        precision=HIGHEST)
    sub = Y[idx_pad] * valid[..., None].astype(Y.dtype)
    b = lam_y * jnp.sum(sub, axis=1)                        # E=1 at observed
    x = get_solver(solver)(A, b)
    nonempty = jnp.any(valid, axis=1, keepdims=True)
    return jnp.where(nonempty, x, 0.0), e_colsum


class ExpoMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.ExpoMF`` (`expomf.pyx:40-64`)."""

    def __init__(self, num_components: int = 20, lam_y: float = 1.0,
                 weight_decay: float = 0.01, chunk_size: int = 512,
                 solver: str = "cholesky",
                 prefactor: Optional[float] = None):
        super().__init__(num_components)
        self.lam_y = float(lam_y)
        self.weight_decay = float(weight_decay)
        self.chunk_size = int(chunk_size)
        if solver not in ("cholesky", "lu"):
            raise ValueError("solver must be 'cholesky' or 'lu'")
        self.solver = solver
        # paper-correct Gaussian prefactor; pass sqrt(lam_y*pi/2) to
        # replicate the reference's precedence bug bit-for-bit.
        self.prefactor = (math.sqrt(self.lam_y / (2.0 * math.pi))
                          if prefactor is None else float(prefactor))

    def _ensure_tables(self, num_rows_w: int, num_rows_h: int) -> None:
        """randn * 0.01 init with np.random.seed(4321) before W only
        (`expomf.pyx:92-96`) — overrides the uniform base init."""
        K = self.num_components
        if self.W is None:
            np.random.seed(4321)
            self.W = np.random.randn(num_rows_w, K) * 0.01
        if self.H is None:
            self.H = np.random.randn(num_rows_h, K) * 0.01

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

        Xt = X.T.tocsr()
        Xt.sort_indices()
        user_chunks = self._device_chunks(
            build_chunks(X, self.chunk_size, Wd.shape[0],
                         num_components=self.num_components))
        item_chunks = self._device_chunks(
            build_chunks(Xt, self.chunk_size, Hd.shape[0],
                         num_components=self.num_components))

        dtype = config.param_dtype()
        lam_y = jnp.asarray(self.lam_y, dtype)
        ridge = (self.weight_decay / self.lam_y) * jnp.eye(
            self.num_components, dtype=dtype)               # expomf.pyx:171
        prefactor = jnp.asarray(self.prefactor, dtype)
        mu = mesh.put_replicated(
            jnp.full((Hd.shape[0],), 0.01, dtype))          # expomf.pyx:111
        self._state["mu"] = mu
        start_epoch = 0
        if resume and checkpoint_path is not None \
                and __import__("os").path.exists(checkpoint_path):
            from ..utils.checkpoint import load_checkpoint
            self._state, last_epoch, _ = load_checkpoint(
                checkpoint_path, self._state, rows=self._state_rows())
            start_epoch = last_epoch + 1
            mu = self._state["mu"]

        a1 = a2 = 1.0  # Beta(1, 1) prior (expomf.pyx:113-114,142)
        # resolve CYMF_TPU_ALS_CHOL once so the explicit form is a static
        # jit key (ops/als.py)
        from ..ops.als import resolve_chol_solver
        solver_r = resolve_chol_solver(self.solver, self.num_components)

        if mesh.num_devices > 1:
            # explicit shard_map chunks: row-sharded tables, E blocks
            # partitioned by the other-side axis, O(chunk) collectives
            # (parallel/shard_step.py::sharded_expomf_chunk)
            from ..parallel.shard_step import sharded_expomf_chunk

            @functools.lru_cache(maxsize=None)
            def _sharded_fn(mu_axis, n_rows, n_cols):
                return sharded_expomf_chunk(
                    mesh, self.lam_y, self.weight_decay, self.prefactor,
                    self.num_components, solver_r, mu_axis, n_rows,
                    n_cols)

            def epoch_fn(epoch):
                nonlocal mu
                st = self._state
                W0, H0 = st["W"], st["H"]
                Ipad = Hd.shape[0]
                iota_i = jnp.arange(Ipad)
                mu_term_pad = jnp.where(iota_i < I,
                                        (1.0 - mu) / mu, 1.0)  # [Ipad]

                fn_u = _sharded_fn("col", U, I)
                colsum = jnp.zeros((Ipad,), dtype)
                W_new = st["W"]
                for ch in user_chunks:
                    W_new, cs = fn_u(W0, H0, H0, mu_term_pad, W_new,
                                     ch.rows, ch.idx_pad, ch.valid)
                    colsum = colsum + cs
                st["W"] = W_new

                fn_i = _sharded_fn("row", I, U)
                H_new = st["H"]
                for ch in item_chunks:
                    mu_rows = mu_term_pad[jnp.clip(ch.rows, 0, Ipad - 1)]
                    H_new, _ = fn_i(H0, W0, W_new, mu_rows, H_new,
                                    ch.rows, ch.idx_pad, ch.valid)
                st["H"] = H_new

                mu_new = (a1 + colsum - 1.0) / (a1 + a2 + U - 2.0)
                mu = jnp.where(iota_i < I, mu_new, mu)
                self._state["mu"] = mu
        else:
            def epoch_fn(epoch):
                nonlocal mu
                st = self._state
                W0, H0 = st["W"], st["H"]
                W0U, H0I = W0[:U], H0[:I]
                mu_term_items = (1.0 - mu[:I]) / mu[:I]     # [I]

                # user sweep (Y = H0) + colsum of epoch-start Exposure
                colsum = jnp.zeros((I,), dtype)
                W_new = st["W"]
                for ch in user_chunks:
                    x, cs = _expomf_chunk(
                        W0, H0I, H0I, mu_term_items, ch.rows,
                        ch.idx_pad, ch.valid, lam_y, ridge, prefactor,
                        solver=solver_r, num_real_rows=U)
                    W_new = W_new.at[ch.rows].set(x, mode="drop",
                                                  unique_indices=True)
                    colsum = colsum + cs
                st["W"] = W_new
                W_newU = W_new[:U]

                # item sweep: E from (W0, H0), normal equations over the
                # updated W
                mu_term_pad = jnp.concatenate(
                    [mu_term_items, jnp.ones((Hd.shape[0] - I,), dtype)])
                H_new = st["H"]
                for ch in item_chunks:
                    mu_rows = mu_term_pad[jnp.clip(ch.rows, 0,
                                                   Hd.shape[0] - 1)]
                    x, _ = _expomf_chunk(
                        H0, W0U, W_newU, mu_rows[:, None], ch.rows,
                        ch.idx_pad, ch.valid, lam_y, ridge, prefactor,
                        solver=solver_r, num_real_rows=I)
                    H_new = H_new.at[ch.rows].set(x, mode="drop",
                                                  unique_indices=True)
                st["H"] = H_new

                # mu update (expomf.pyx:113-114,142)
                mu_new = (a1 + colsum - 1.0) / (a1 + a2 + U - 2.0)
                mu = mu.at[:I].set(mu_new)
                self._state["mu"] = mu

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = np.array(snap[0]), np.array(snap[1])

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose, ncols=100, checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         start_epoch=start_epoch)
        self.mu = np.asarray(mu[:I])
        self._finalize_fit()

    def _device_chunks(self, chunks: List[AlsChunk]) -> List[AlsChunk]:
        from ..ops.als import place_device_chunks
        return place_device_chunks(self.mesh, chunks)
