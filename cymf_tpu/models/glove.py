"""GloVe (Pennington et al. 2014) — JAX trainer.

Behavioural spec from `/root/reference/cymf/glove.pyx` + `model.pyx:145-204`
+ `optimizer.pyx:85-123`: weighted least squares over co-occurrence counts,

    diff = w_c . h_x + b_c + b_x - log(count)
    f    = min((count / x_max)^alpha, 1)
    L    = 0.5 * f * diff^2

trained with AdaGrad (accumulators initialized to ones) over two embedding
tables and two bias vectors; the final embedding is the average
``(W_central + W_context) / 2`` (`glove.pyx:112`).

Bias handling (``bias_mode``): the default "fused" mode carries the biases
as augmented table columns (``[w | b_c | 1] . [h | 1 | b_x]``) so they get
one AdaGrad update per sample — the GloVe paper's rule, and ~2x faster.
The reference has a quirk here: its backward emits the *bias* gradient once
per latent dimension — K sequential AdaGrad bias updates per sample with
the same gradient (`model.pyx:195-204`); ``bias_mode="kfold"`` replicates
that exactly via the closed form ``delta = -lr * g * sum_{t=1..K}
rsqrt(a0 + t*g^2)``, ``accum += K * g^2``.

Fixed reference defect (SURVEY.md §7): the context bias is sized by
``X.shape[1]`` (the reference sizes it with ``X.shape[0]``,
`glove.pyx:94` — identical for the square matrices it is used with).

Redesign: the Hogwild ``prange`` over co-occurrence triples
(`glove.pyx:151-153`) becomes a jitted ``lax.scan`` over minibatches with
segment-sum dedup and sparse scatter updates, sharded over the mesh.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

from .. import config
from ..ops.segment import dedup_rows
from ..optim import AdaGrad
from ..parallel.mesh import current_mesh
from .base import progress


def augment_tables(W_central, central_bias, W_context, context_bias):
    """The fused-bias augmented layout

        Zc = [w | b_central | 1]        Zx = [h | 1 | b_context]

    so ``Zc . Zx = w.h + b_c + b_x``; the gradient masks of the fused
    epochs (`_glove_epoch`, `parallel/shard_step.py`) keep the constant
    columns frozen."""
    V1 = W_central.shape[0]
    V2 = W_context.shape[0]
    Zc = np.concatenate(
        [W_central, np.asarray(central_bias).reshape(V1, 1),
         np.ones((V1, 1))], axis=1)
    Zx = np.concatenate(
        [W_context, np.ones((V2, 1)),
         np.asarray(context_bias).reshape(V2, 1)], axis=1)
    return Zc, Zx


def _bias_kfold_update(bias, accum, rows, grads, lr, k_steps: int,
                       presorted: bool = False):
    """K consecutive AdaGrad steps with a constant gradient, closed form.

    ``bias``/``accum`` are (V, 1) column vectors, so these are
    row-addressed scatters like the embedding tables'.
    """
    drop = bias.shape[0]
    rows, g = dedup_rows(rows, grads[:, None], drop, presorted=presorted)
    crows = jnp.clip(rows, 0, drop - 1)
    a0 = accum[crows]                                   # (B, 1)
    t = jnp.arange(1, k_steps + 1, dtype=bias.dtype)
    denom = jnp.sqrt(a0 + t[None, :] * jnp.square(g))
    delta = -lr * g[:, :1] * jnp.sum(1.0 / denom, axis=1, keepdims=True)
    accum = accum.at[rows].set(a0 + k_steps * jnp.square(g[:, :1]),
                               mode="drop", unique_indices=True)
    bias = bias.at[rows].add(delta, mode="drop", unique_indices=True)
    return bias, accum


@functools.lru_cache(maxsize=16)
def _sharded_glove_epoch_jit(mesh, lr: float, x_max: float, alpha: float,
                             K: int, num_central: int):
    """Cached jitted shard_map epoch (fused-bias mode) — row-sharded
    augmented tables, sharded co-occurrence batches, O(batch) collectives
    (parallel/shard_step.py::sharded_glove_epoch)."""
    from ..parallel.shard_step import sharded_glove_epoch
    opt = AdaGrad(lr)
    return opt, sharded_glove_epoch(mesh, opt, x_max, alpha, K, num_central)


@functools.lru_cache(maxsize=16)
def _sharded_glove_kfold_epoch_jit(mesh, lr: float, x_max: float,
                                   alpha: float, K: int, num_central: int):
    """Cached jitted shard_map epoch for the reference-exact kfold bias
    mode (parallel/shard_step.py::sharded_glove_kfold_epoch)."""
    from ..parallel.shard_step import sharded_glove_kfold_epoch
    opt = AdaGrad(lr)
    return opt, sharded_glove_kfold_epoch(mesh, opt, x_max, alpha, K,
                                          num_central)


@functools.lru_cache(maxsize=64)
def _glove_epoch_jit(lr: float, x_max: float, alpha: float, K: int,
                     num_central: int, mode: str, bias_mode: str):
    opt = AdaGrad(lr)
    fn = jax.jit(
        functools.partial(_glove_epoch, optimizer=opt, x_max=x_max,
                          alpha=alpha, learning_rate=lr, num_components=K,
                          num_central=num_central, update_mode=mode,
                          bias_mode=bias_mode),
        donate_argnums=tuple(range(8)))
    return opt, fn


def _glove_epoch(Wc, Wx, bc, bx, ow, oh, abc, abx, c_steps, x_steps,
                 n_steps_counts, n_valid, *, optimizer, x_max, alpha,
                 learning_rate, num_components, num_central,
                 update_mode="dense", bias_mode="fused"):
    """``bias_mode``:

    * "fused" (default): biases ride as augmented table columns —
      ``[w | b_c | 1] . [h | 1 | b_x] = w.h + b_c + b_x`` — so the bias
      gradient flows through the same dense AdaGrad update as the
      embeddings (one update per sample, the GloVe paper's rule; the
      constant columns are masked out of the gradient).  ~2x faster.
    * "kfold": separate bias vectors with the reference's quirk replicated
      exactly — K consecutive AdaGrad bias updates per sample
      (`model.pyx:195-204` emits the bias gradient once per latent dim),
      applied in closed form.
    In fused mode Wc/Wx are [V, K+2] augmented tables and bc/bx are unused
    (passed through).
    """
    S, B = c_steps.shape
    lr = learning_rate
    K = num_components

    def step(carry, xs):
        Wc, Wx, bc, bx, ow, oh, abc, abx, loss_acc = carry
        c, x, cnt, sidx = xs
        # padding triples carry an out-of-range central id (sorts last,
        # OOB scatters dropped) - see the sentinel note in models/bpr.py
        in_data = c < num_central
        mf = in_data.astype(Wc.dtype)

        wc, hx = Wc[c], Wx[x]
        f = jnp.minimum(jnp.power(cnt / x_max, alpha), 1.0)
        if bias_mode == "fused":
            diff = jnp.sum(wc * hx, axis=1) - jnp.log(cnt)
        else:
            diff = (jnp.sum(wc * hx, axis=1) + bc[c, 0] + bx[x, 0]
                    - jnp.log(cnt))
        loss = 0.5 * f * jnp.square(diff) * mf
        fd = (f * diff * mf)[:, None]

        g_c = fd * hx
        g_x = fd * wc
        if bias_mode == "fused":
            # the constant-1 columns must stay constant
            width = Wc.shape[1]
            col = jnp.arange(width)
            g_c = g_c * (col != K + 1)
            g_x = g_x * (col != K)
        if update_mode == "dense":
            # batches are host-presorted by central word
            Wc, ow = optimizer.update_dense(Wc, ow, [(c, g_c)],
                                            rows_sorted=True)
            Wx, oh = optimizer.update_dense(Wx, oh, [(x, g_x)])
        else:
            Wc, ow = optimizer.update_rows(Wc, ow, c, g_c)
            Wx, oh = optimizer.update_rows(Wx, oh, x, g_x)
        if bias_mode == "kfold":
            bc, abc = _bias_kfold_update(bc, abc, c, fd[:, 0], lr,
                                         num_components, presorted=True)
            bx, abx = _bias_kfold_update(bx, abx, x, fd[:, 0], lr,
                                         num_components)
        return (Wc, Wx, bc, bx, ow, oh, abc, abx,
                loss_acc + jnp.sum(loss)), None

    init = (Wc, Wx, bc, bx, ow, oh, abc, abx, jnp.zeros((), Wc.dtype))
    (Wc, Wx, bc, bx, ow, oh, abc, abx, loss), _ = jax.lax.scan(
        step, init, (c_steps, x_steps, n_steps_counts, jnp.arange(S)))
    return Wc, Wx, bc, bx, ow, oh, abc, abx, \
        loss / jnp.maximum(n_valid, 1).astype(Wc.dtype)


class GloVe:
    """API-compatible rebuild of ``cymf.GloVe`` (`glove.pyx:46-75`)."""

    def __init__(self, num_components: int = 50, learning_rate: float = 0.01,
                 alpha: float = 0.75, x_max: float = 10.0,
                 batch_size: int = 4096, update_mode: str = "auto",
                 bias_mode: str = "fused"):
        self.num_components = int(num_components)
        self.learning_rate = float(learning_rate)
        self.alpha = float(alpha)
        self.x_max = float(x_max)
        self.batch_size = int(batch_size)
        if update_mode not in ("auto", "dense", "sparse"):
            raise ValueError("update_mode must be auto|dense|sparse")
        self.update_mode = update_mode
        if bias_mode not in ("fused", "kfold"):
            raise ValueError("bias_mode must be fused|kfold")
        self.bias_mode = bias_mode
        self.W = None
        self.bias = None
        self._state = None  # device tables + AdaGrad state during fit

    def fit(self, X, num_epochs: int, num_threads: int = 1,
            verbose: bool = False, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train on a sparse co-occurrence matrix (`glove.pyx:75-112`).
        ``num_threads`` accepted for API compatibility; ignored.
        ``checkpoint_path`` persists all four tables + AdaGrad accumulators
        per ``checkpoint_every`` epochs; ``resume=True`` continues."""
        if X is None:
            raise ValueError()
        if not sparse.issparse(X):
            raise TypeError("X must be a type of scipy.sparse.*_matrix.")

        K = self.num_components
        V1, V2 = X.shape
        # init per glove.pyx:91-94 (no seed: uses ambient numpy state)
        W_central = np.random.uniform(-0.5, 0.5, (V1, K)) / K
        central_bias = np.random.uniform(-0.5, 0.5, (V1,)) / K
        W_context = np.random.uniform(-0.5, 0.5, (V2, K)) / K
        context_bias = np.random.uniform(-0.5, 0.5, (V2,)) / K

        coo = X.tocoo()
        # same global-RandomState stream as sklearn.utils.shuffle
        perm = np.random.permutation(coo.nnz)
        central = coo.row.astype(np.int32)[perm]
        context = coo.col.astype(np.int32)[perm]
        counts = coo.data.astype(np.float64)[perm]

        N = len(central)
        mesh = current_mesh()
        B = mesh.pad_rows(min(self.batch_size, max(N, mesh.num_devices)))
        S = max(1, -(-N // B))
        pad = S * B - N
        if pad:
            central = np.concatenate(
                [central, np.full(pad, np.int32(2**31 - 1))])
            context = np.concatenate([context, np.zeros(pad, np.int32)])
            counts = np.concatenate([counts, np.ones(pad)])
        # per-batch sort by central word (sorted-scatter fast path; order
        # within a synchronous batch is semantically irrelevant; padding
        # sentinels sort last and are masked by the in-data check)
        c2 = central.reshape(S, B)
        x2 = context.reshape(S, B)
        n2 = counts.reshape(S, B)
        order = np.argsort(c2, axis=1, kind="stable")
        c2 = np.take_along_axis(c2, order, axis=1)
        x2 = np.take_along_axis(x2, order, axis=1)
        n2 = np.take_along_axis(n2, order, axis=1)

        dtype = config.param_dtype()

        def table(T):
            if T.ndim == 1:
                T = T[:, None]  # column layout: row-addressed bias scatters
            n_pad = mesh.pad_rows(T.shape[0])
            if n_pad != T.shape[0]:
                T = np.concatenate(
                    [T, np.zeros((n_pad - T.shape[0],) + T.shape[1:],
                                 T.dtype)])
            return jax.device_put(jnp.asarray(T, dtype), mesh.table())

        if self.bias_mode == "fused":
            Wc_np, Wx_np = augment_tables(W_central, central_bias,
                                          W_context, context_bias)
            Wc, Wx = table(Wc_np), table(Wx_np)
            bc, bx = table(np.zeros(1)), table(np.zeros(1))  # unused
        else:
            Wc, Wx = table(W_central), table(W_context)
            bc, bx = table(central_bias), table(context_bias)
        c_steps = jax.device_put(c2, mesh.batch2d())
        x_steps = jax.device_put(x2, mesh.batch2d())
        n_counts = jax.device_put(jnp.asarray(n2, dtype), mesh.batch2d())

        from .bpr import choose_update_mode
        mode = choose_update_mode(self.update_mode, 2 * B,
                                  Wc.shape[0] + Wx.shape[0])
        if mesh.num_devices > 1 and self.bias_mode == "fused":
            opt, sh_fn = _sharded_glove_epoch_jit(
                mesh, self.learning_rate, self.x_max, self.alpha, K, V1)

            def epoch_jit(Wc, Wx, bc, bx, ow, oh, abc, abx, c_st, x_st,
                          n_st, nv):
                Wc, Wx, ow, oh, loss = sh_fn(Wc, Wx, ow, oh, c_st, x_st,
                                             n_st, nv)
                return Wc, Wx, bc, bx, ow, oh, abc, abx, loss
        elif mesh.num_devices > 1:
            # reference-exact kfold bias rule, explicitly partitioned
            # (parallel/shard_step.py::sharded_glove_kfold_epoch)
            opt, epoch_jit = _sharded_glove_kfold_epoch_jit(
                mesh, self.learning_rate, self.x_max, self.alpha, K, V1)
        else:
            opt, epoch_jit = _glove_epoch_jit(
                self.learning_rate, self.x_max, self.alpha, K, V1, mode,
                self.bias_mode)
        # accumulators init ones (optimizer.pyx:96-99)
        names = ("Wc", "Wx", "bc", "bx", "ow", "oh", "abc", "abx")
        self._state = dict(zip(names, (
            Wc, Wx, bc, bx, opt.init(Wc), opt.init(Wx), jnp.ones_like(bc),
            jnp.ones_like(bx))))
        # real rows of each state entry (the rest is mesh padding); the
        # fused bias mode keeps one unused bias row per side
        b1, b2 = (1, 1) if self.bias_mode == "fused" else (V1, V2)
        rows = dict(zip(names, (V1, V2, b1, b2, V1, V2, b1, b2)))
        start_epoch = 0
        if resume and checkpoint_path is not None \
                and os.path.exists(checkpoint_path):
            from ..utils.checkpoint import load_checkpoint
            self._state, last_epoch, _ = load_checkpoint(
                checkpoint_path, self._state, rows=rows)
            start_epoch = last_epoch + 1

        loss = None
        from ..utils.checkpoint import AsyncCheckpointer
        ckpt = AsyncCheckpointer() if checkpoint_path else None
        with progress(num_epochs, initial=start_epoch,
                      disable=not verbose) as bar:
            for it in range(start_epoch, num_epochs):
                out = epoch_jit(*(self._state[k] for k in names), c_steps,
                                x_steps, n_counts, jnp.asarray(N, jnp.int32))
                self._state = dict(zip(names, out[:8]))
                loss = out[8]
                if verbose:
                    bar.set_description(
                        f"ITER={it + 1:{len(str(num_epochs))}}, "
                        f"LOSS: {float(jax.device_get(loss)):.4f}")
                bar.update(1)
                if ckpt and (it + 1) % checkpoint_every == 0:
                    ckpt.save(checkpoint_path, self._state, it, rows=rows)
        if ckpt:
            ckpt.wait()

        self.last_loss = float(jax.device_get(loss)) if loss is not None \
            else None
        self._finalize_fit(V1, V2)

    def _finalize_fit(self, V1: int, V2: int) -> None:
        """Pull the learned tables to host and drop the device state."""
        K = self.num_components
        st = {k: np.asarray(v) for k, v in self._state.items()
              if k in ("Wc", "Wx", "bc", "bx")}
        self._state = None
        if self.bias_mode == "fused":
            self.W_central = st["Wc"][:V1, :K].astype(np.float64)
            self.W_context = st["Wx"][:V2, :K].astype(np.float64)
            self.bias = st["Wc"][:V1, K].astype(np.float64)
            self.context_bias = st["Wx"][:V2, K + 1].astype(np.float64)
        else:
            self.W_central = st["Wc"][:V1].astype(np.float64)
            self.W_context = st["Wx"][:V2].astype(np.float64)
            self.bias = st["bc"][:V1, 0].astype(np.float64)
            self.context_bias = st["bx"][:V2, 0].astype(np.float64)
        self.W = (self.W_central + self.W_context) / 2.0  # glove.pyx:112

    def save_word2vec_format(self, path, index2word):
        """gensim-compatible word2vec text export (`glove.pyx:164-177`)."""
        from pathlib import Path
        output = Path(path)
        with output.open("w") as f:
            f.write(f"{self.W.shape[0]} {self.W.shape[1]}\n")
            for i in range(self.W.shape[0]):
                f.write(f"{index2word[i]} "
                        + " ".join(map(str, self.W[i])) + "\n")
