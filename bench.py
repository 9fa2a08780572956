"""Benchmarks on the GPU.  Prints ONE JSON line for the selected BENCH_MODEL.

Headline (default ``bpr``): BPR training throughput of the XLA batch
engine at ML-20M shapes (138,493 users x 26,744 items, 20M interactions,
d=20).  Baseline: the reference's README quickstart rate — 98.46 epochs/s
on ml-100k with 8 OpenMP threads ~= 5.4M interaction-updates/s
(BASELINE.md).

Times are host-clock walls around work that ends in ``block_until_ready``
(or a device->host fetch), after a warm-up call that compiles.  Every line
names the card: JAX's ``device_kind`` and device count, and the
``nvidia-smi`` name and power limit.  A mode that fails raises, and the
process exits non-zero; without a GPU nothing runs.

Environment knobs:
  BENCH_MODEL=bpr|wmf|wmf256|relmf|relmf_ml20m|expomf|glove|evaluator|
              recommend|all
  BENCH_SMALL=1     quick run (1M interactions)
  BENCH_BATCH=N     override batch size (default 131072)
  BENCH_DIM=N       override embedding dim
  BENCH_EPOCHS=N    timed epochs (default 3)

Run: ``python bench.py``.
"""

from __future__ import annotations

import functools
import json
import os
import time

import numpy as np


def _timed(fn, reps):
    """Mean wall of ``reps`` calls of ``fn`` after one warm-up call; each
    call's result is blocked on."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _small():
    return os.environ.get("BENCH_SMALL") == "1"


def bench_bpr():
    """The XLA batch engine (scatter-based dense updates) at ML-20M
    shapes — the engine ``BPR.fit`` runs."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.dataset.synthetic import bench_interactions
    from cymf_tpu.models.bpr import _bpr_epoch
    from cymf_tpu.ops.hashset import build_pair_hashset
    from cymf_tpu.optim import Adam
    from cymf_tpu.parallel.mesh import current_mesh

    U, I = 138493, 26744
    nnz = 1_000_000 if _small() else 20_000_263
    K = int(os.environ.get("BENCH_DIM", "20"))
    B = int(os.environ.get("BENCH_BATCH", "131072"))
    epochs = int(os.environ.get("BENCH_EPOCHS", "3"))

    mesh = current_mesh()
    B = mesh.pad_rows(B)
    users, items = bench_interactions(U, I, nnz, seed=0)
    S = nnz // B
    users = users[:S * B].reshape(S, B)
    items = items[:S * B].reshape(S, B)
    order = np.argsort(users, axis=1, kind="stable")
    users = np.take_along_axis(users, order, axis=1)
    items = np.take_along_axis(items, order, axis=1)

    rng = np.random.default_rng(0)
    W = jax.device_put(jnp.asarray(
        rng.uniform(-0.1, 0.1, (mesh.pad_rows(U), K)) / K, jnp.float32),
        mesh.table())
    H = jax.device_put(jnp.asarray(
        rng.uniform(-0.1, 0.1, (mesh.pad_rows(I), K)) / K, jnp.float32),
        mesh.table())
    u_steps = jax.device_put(jnp.asarray(users), mesh.batch2d())
    i_steps = jax.device_put(jnp.asarray(items), mesh.batch2d())
    hs = jax.tree_util.tree_map(
        mesh.put_replicated, build_pair_hashset(users.ravel(), items.ravel()))

    opt = Adam(0.001)
    state = [W, H, opt.init(W), opt.init(H)]
    step = jax.jit(
        functools.partial(_bpr_epoch, optimizer=opt, weight_decay=0.01,
                          num_users=U, num_items=I, u_presorted=True),
        donate_argnums=(0, 1, 2, 3))
    key = jax.random.PRNGKey(0)
    n_valid = jnp.asarray(S * B, jnp.int32)

    def run():
        state[0], state[1], state[2], state[3], loss = step(
            state[0], state[1], state[2], state[3], u_steps, i_steps, hs,
            n_valid, key)
        return loss

    ips = S * B / _timed(run, epochs)
    return {"metric": "bpr_interactions_per_sec", "value": ips,
            "unit": f"interactions/s (d={K}, batch {B})",
            "vs_baseline": ips / 5.4e6}


def _ml20m_matrix():
    from scipy import sparse

    from cymf_tpu.dataset.synthetic import bench_interactions

    U, I = 138493, 26744
    nnz = 1_000_000 if _small() else 20_000_263
    users, items = bench_interactions(U, I, nnz, seed=0)
    return sparse.csr_matrix(
        (np.ones(len(users), np.float64), (users, items)), shape=(U, I))


def _fit_wall(model, X, epochs):
    """Mean fit() wall per epoch after a one-epoch warm-up fit."""
    model.fit(X, num_epochs=1, verbose=False)  # compile
    t0 = time.perf_counter()
    model.fit(X, num_epochs=epochs, verbose=False)
    _ = model.W  # device->host fetch: the fit has finished
    return (time.perf_counter() - t0) / epochs


def bench_wmf(K=None):
    """ALS sweep rate (one user + one item half-sweep) through
    ``WMF.fit`` at ML-20M shapes (reference: ~10 epochs/s on the 200x
    smaller ml-100k => ~554k interactions solved/s)."""
    from cymf_tpu.models.wmf import WMF

    K = K or int(os.environ.get("BENCH_DIM", "64"))
    X = _ml20m_matrix()
    dt = _fit_wall(WMF(num_components=K), X,
                   int(os.environ.get("BENCH_EPOCHS", "3")))
    rate = X.nnz / dt
    return {"metric": f"wmf_d{K}_interactions_per_sec", "value": rate,
            "unit": "interactions/s (full user+item sweep, fit() wall)",
            "vs_baseline": rate / 553_750.0}


def bench_wmf256():
    return bench_wmf(256)


def bench_relmf():
    """RelMF sampled-cell rate through ``RelMF.fit`` at ml-1m shapes
    (22.4M cells/epoch).  Reference: ~3 epochs/s at ml-100k => ~4.8M
    cells/s."""
    from cymf_tpu.dataset import SyntheticImplicitDataset
    from cymf_tpu.models.relmf import RelMF

    U, I = (1200, 800) if _small() else (6040, 3706)
    data = SyntheticImplicitDataset(num_user=U, num_item=I, rank=8,
                                    density=0.04, seed=0)
    m = RelMF(num_components=20, batch_size=131072)
    dt = _fit_wall(m, data.train, int(os.environ.get("BENCH_EPOCHS", "3")))
    rate = m._samples_per_epoch / dt
    return {"metric": "relmf_cells_per_sec", "value": rate,
            "unit": "sampled cells/s (fit() wall)",
            "vs_baseline": rate / 4.8e6}


def bench_relmf_ml20m():
    """RelMF's chunked XLA scan at ML-20M shapes: U x I = 3.7e9 cells per
    epoch at B=131072 (28,259 steps); BENCH_SMALL times 1,000 steps."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu import config
    from cymf_tpu.dataset.synthetic import bench_interactions
    from cymf_tpu.models.relmf import _CHUNK_STEPS, _relmf_epoch_jit
    from cymf_tpu.ops.hashset import build_pair_hashset

    U, I = 138493, 26744
    B = int(os.environ.get("BENCH_BATCH", "131072"))
    K = int(os.environ.get("BENCH_DIM", "20"))
    full_steps = -(-(U * I) // B)
    steps = 1000 if _small() else full_steps
    rng = np.random.default_rng(0)
    users, items = bench_interactions(U, I, 20_000_263, seed=0)
    key = jax.random.PRNGKey(0)
    hs = jax.tree_util.tree_map(jnp.asarray,
                                build_pair_hashset(users, items))
    col_mean = np.bincount(items, minlength=I).astype(np.float64) / U
    props = jnp.asarray(
        (np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5)[:, None],
        dtype=config.param_dtype())
    W = jnp.asarray(rng.uniform(-0.1, 0.1, (U, K)) / K, jnp.float32)
    H = jnp.asarray(rng.uniform(-0.1, 0.1, (I, K)) / K, jnp.float32)

    def chunk_fn(n):
        return _relmf_epoch_jit("adam", 0.001, 0.01, 0.1, U, I, n, B,
                                "dense", True)

    ch = min(steps, _CHUNK_STEPS)
    n_full, rem = divmod(steps, ch)
    opt, chunk = chunk_fn(ch)
    parts = [(chunk, ch)] * n_full + ([(chunk_fn(rem)[1], rem)]
                                      if rem else [])
    state = [W, H, opt.init(W), opt.init(H)]

    def run():
        loss = jnp.zeros(())
        off = 0
        for fn, n in parts:
            state[0], state[1], state[2], state[3], part = fn(
                state[0], state[1], state[2], state[3], hs, props, key,
                jnp.asarray(off, jnp.int32))
            loss = loss + part
            off += n
        return loss

    rate = steps * B / _timed(run, int(os.environ.get("BENCH_EPOCHS", "1")))
    return {"metric": "relmf_ml20m_cells_per_sec", "value": rate,
            "unit": f"sampled cells/s ({steps} steps x {B})",
            "vs_baseline": rate / 4.8e6}


def bench_expomf():
    """ExpoMF EM epoch rate through ``ExpoMF.fit`` at ml-1m shapes (the
    reference densifies U x I and has no comparable rate, so vs_baseline
    is null)."""
    from cymf_tpu.dataset import SyntheticImplicitDataset
    from cymf_tpu.models.expomf import ExpoMF

    U, I = (1200, 800) if _small() else (6040, 3706)
    data = SyntheticImplicitDataset(num_user=U, num_item=I, rank=8,
                                    density=0.04, seed=0)
    dt = _fit_wall(ExpoMF(num_components=20), data.train,
                   int(os.environ.get("BENCH_EPOCHS", "3")))
    return {"metric": "expomf_epochs_per_sec_ml1m", "value": 1.0 / dt,
            "unit": "epochs/s (fit() wall)", "vs_baseline": None}


def bench_glove():
    """GloVe epoch rate: 50k vocab, ~3M co-occurrence triples, d=50,
    fused-bias AdaGrad, streams resident before timing (GloVe's streams
    are static per fit, so the trainer pays prep/upload once)."""
    import jax.numpy as jnp
    from scipy import sparse

    from cymf_tpu.models.glove import _glove_epoch_jit, augment_tables

    V = 5000 if _small() else 50000
    nnz = 200_000 if _small() else 3_000_000
    K = 50
    rng = np.random.default_rng(0)
    X = sparse.csr_matrix(
        (rng.integers(1, 50, nnz).astype(np.float64),
         (rng.integers(0, V, nnz), rng.integers(0, V, nnz))), shape=(V, V))
    coo = X.tocoo()
    B = int(os.environ.get("BENCH_BATCH", "131072"))
    B = min(B, max(1024, (X.nnz // 1024) * 1024))
    S = max(1, X.nnz // B)
    c2 = coo.row.astype(np.int32)[:S * B].reshape(S, B)
    order = np.argsort(c2, axis=1, kind="stable")
    c2 = np.take_along_axis(c2, order, 1)
    x2 = np.take_along_axis(
        coo.col.astype(np.int32)[:S * B].reshape(S, B), order, 1)
    n2 = np.take_along_axis(coo.data[:S * B].reshape(S, B), order, 1)

    Zc, Zx = augment_tables(
        rng.normal(size=(V, K)) * 0.1, rng.normal(size=(V, 1)),
        rng.normal(size=(V, K)) * 0.1, rng.normal(size=(V, 1)))
    opt, fn = _glove_epoch_jit(0.01, 10.0, 0.75, K, V, "dense", "fused")
    Wc, Wx = jnp.asarray(Zc, jnp.float32), jnp.asarray(Zx, jnp.float32)
    # distinct buffers: the epoch donates all 8 state args
    bc = jnp.zeros((1, 1), jnp.float32)
    bx = jnp.zeros((1, 1), jnp.float32)
    st = [Wc, Wx, bc, bx, opt.init(Wc), opt.init(Wx), jnp.ones_like(bc),
          jnp.ones_like(bx)]
    c_d, x_d = jnp.asarray(c2), jnp.asarray(x2)
    n_d = jnp.asarray(n2.astype(np.float32))
    nv = jnp.asarray(S * B, jnp.int32)

    def run():
        out = fn(*st, c_d, x_d, n_d, nv)
        st[:] = out[:8]
        return out[8]

    rate = S * B / _timed(run, int(os.environ.get("BENCH_EPOCHS", "3")))
    return {"metric": "glove_triples_per_sec", "value": rate,
            "unit": "triples/s", "vs_baseline": None}


def bench_evaluator():
    """Sampled-negative evaluation rate at ml-1m shapes (the reference's
    serial per-user Python loop is the epoch-validation bottleneck)."""
    from scipy import sparse

    from cymf_tpu.evaluation.evaluator import Evaluator

    U, I = (1200, 800) if _small() else (6040, 3706)
    rng = np.random.default_rng(0)
    X_test = sparse.random(U, I, density=0.02, random_state=0, format="csr",
                           data_rvs=lambda n: np.ones(n))
    X_train = sparse.random(U, I, density=0.04, random_state=1, format="csr",
                            data_rvs=lambda n: np.ones(n))
    W = rng.normal(size=(U, 20))
    H = rng.normal(size=(I, 20))
    ev = Evaluator(X_test, X_train, k=5, num_negatives=100)
    ev.evaluate(W, H)  # compile
    reps = int(os.environ.get("BENCH_EPOCHS", "5"))
    t0 = time.perf_counter()
    for s in range(reps):
        ev.evaluate(W, H, seed=s)  # returns host floats: work has ended
    dt = (time.perf_counter() - t0) / reps
    return {"metric": "evaluator_users_per_sec", "value": U / dt,
            "unit": "users/s", "vs_baseline": None}


def bench_recommend():
    """Full-catalog top-10 recommendation rate at ML-20M shapes (138k
    users x 27k items, d=20, train-positive exclusion).  The reference
    has no batch recommendation path, so there is no baseline."""
    from cymf_tpu.evaluation.recommend import recommend

    X = _ml20m_matrix()
    U, I = X.shape
    K = 20
    rng = np.random.default_rng(0)
    W = rng.normal(size=(U, K)).astype(np.float32)
    H = rng.normal(size=(I, K)).astype(np.float32)
    recommend(W, H, k=10, exclude=X)  # compile
    reps = int(os.environ.get("BENCH_EPOCHS", "3"))
    t0 = time.perf_counter()
    for _ in range(reps):
        _, topk = recommend(W, H, k=10, exclude=X)  # host arrays
    dt = (time.perf_counter() - t0) / reps
    assert topk.shape == (U, 10)
    return {"metric": "recommend_users_per_sec", "value": U / dt,
            "unit": "users/s (full-catalog top-10, train exclusion)",
            "vs_baseline": None}


_MODES = {
    "bpr": bench_bpr,
    "wmf": bench_wmf,
    "wmf256": bench_wmf256,
    "relmf": bench_relmf,
    "relmf_ml20m": bench_relmf_ml20m,
    "expomf": bench_expomf,
    "glove": bench_glove,
    "evaluator": bench_evaluator,
    "recommend": bench_recommend,
}


def main():
    from cymf_tpu.utils.runtime import (card_info, enable_compile_cache,
                                        require_gpu)

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    devices = require_gpu()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "card": card_info()}
    model = os.environ.get("BENCH_MODEL", "bpr")
    names = list(_MODES) if model == "all" else [model]
    for name in names:
        print(json.dumps(dict(_MODES[name](), mode=name, device=device)),
              flush=True)


if __name__ == "__main__":
    main()
