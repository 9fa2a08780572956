"""WMF tests: exact numerical parity of the batched-Cholesky ALS against a
straightforward numpy implementation of the reference update equations
(`/root/reference/cymf/wmf.pyx:136-174`), plus convergence checks."""

import numpy as np
import pytest
from scipy import sparse

from cymf_tpu import AoaEvaluator
from cymf_tpu.models.wmf import WMF
from cymf_tpu.dataset import SyntheticImplicitDataset


def _numpy_als_epochs(X, W, H, weight, wd, epochs):
    """Direct implementation of the ALS equations from the paper/reference:
    per row A = YtY + wd I + (c-1) sum yy^T, b = c sum y, zeros for empty."""
    W = W.copy()
    H = H.copy()
    K = W.shape[1]

    def sweep(csr, Xtab, Y):
        YtY = Y.T @ Y
        A0 = YtY + wd * np.eye(K)
        for r in range(csr.shape[0]):
            idx = csr.indices[csr.indptr[r]:csr.indptr[r + 1]]
            if len(idx) == 0:
                Xtab[r] = 0.0
                continue
            sub = Y[idx]
            A = A0 + (weight - 1.0) * sub.T @ sub
            b = weight * sub.sum(axis=0)
            Xtab[r] = np.linalg.solve(A, b)

    Xt = X.T.tocsr()
    for _ in range(epochs):
        sweep(X, W, H)
        sweep(Xt, H, W)
    return W, H


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=90, num_item=70, rank=4,
                                    density=0.15, seed=2)


@pytest.mark.parametrize("solver", ["cholesky", "lu"])
def test_wmf_matches_numpy_reference_equations(data, solver):
    X = sparse.csr_matrix(data.train).astype(np.float64)
    model = WMF(num_components=8, weight_decay=0.05, weight=5.0,
                chunk_size=32, solver=solver)
    model.fit(X, num_epochs=2, verbose=False)

    np.random.seed(4321)
    K = 8
    W0 = np.random.uniform(-0.1, 0.1, size=(X.shape[0], K)) / K
    H0 = np.random.uniform(-0.1, 0.1, size=(X.shape[1], K)) / K
    W_ref, H_ref = _numpy_als_epochs(X, W0, H0, 5.0, 0.05, 2)

    np.testing.assert_allclose(model.W, W_ref, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(model.H, H_ref, rtol=5e-3, atol=5e-4)


def test_wmf_empty_rows_zeroed():
    X = np.zeros((6, 5))
    X[0, :3] = 1.0
    X[2, 1] = 1.0  # rows 1,3,4,5 empty; column 0,2,3,4 partially empty
    model = WMF(num_components=3, chunk_size=4)
    model.fit(sparse.csr_matrix(X), num_epochs=1, verbose=False)
    np.testing.assert_allclose(model.W[[1, 3, 4, 5]], 0.0)
    np.testing.assert_allclose(model.H[[3, 4]], 0.0)  # items 3,4 unobserved


def test_wmf_improves_ranking(data):
    ev = AoaEvaluator(data.test, data.train, metrics=["DCG"], k=5)
    model = WMF(num_components=8, weight_decay=0.05, weight=10.0)
    np.random.seed(4321)
    W0 = np.random.uniform(-0.1, 0.1, (data.num_user, 8)) / 8
    H0 = np.random.uniform(-0.1, 0.1, (data.num_item, 8)) / 8
    before = ev.evaluate(W0, H0)["DCG@5"]
    model.fit(data.train, num_epochs=5, verbose=False)
    after = ev.evaluate(model.W, model.H)["DCG@5"]
    assert after > before + 0.1, (before, after)


def test_wmf_early_stopping(data):
    ev = AoaEvaluator(data.valid, data.train, metrics=["DCG"], k=5)
    model = WMF(num_components=8)
    model.fit(data.train, num_epochs=40, valid_evaluator=ev,
              early_stopping=True, verbose=False)
    restored = ev.evaluate(model.W, model.H)["DCG@5"]
    assert restored == pytest.approx(model.valid_dcg, abs=1e-6)


def test_wmf_invalid_solver():
    with pytest.raises(ValueError):
        WMF(solver="qr")


def test_woodbury_routing_matches_standard(monkeypatch):
    """The Woodbury chunk solve routes small-P chunks and produces the
    same fit as the standard form."""
    from scipy import sparse

    from cymf_tpu import WMF

    X = sparse.random(300, 200, density=0.05, random_state=0,
                      format="csr", data_rvs=lambda n: np.ones(n))

    import jax

    from cymf_tpu.parallel import MeshContext, use_mesh

    def run(mode, n_dev=1):
        monkeypatch.setenv("CYMF_TPU_ALS_WOODBURY", mode)
        np.random.seed(3)
        with use_mesh(MeshContext.create(jax.devices()[:n_dev])):
            m = WMF(num_components=16, chunk_size=128)
            m.fit(X, num_epochs=3, verbose=False)
            return m.W.copy(), m.H.copy()

    W_off, H_off = run("off")
    W_on, H_on = run("on")
    np.testing.assert_allclose(W_on, W_off, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(H_on, H_off, rtol=2e-3, atol=2e-4)
    # sharded path: trace-time Woodbury routing in sharded_wmf_chunk
    W8_on, H8_on = run("on", n_dev=8)
    monkeypatch.delenv("CYMF_TPU_ALS_WOODBURY")
    np.testing.assert_allclose(W8_on, W_off, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(H8_on, H_off, rtol=2e-3, atol=2e-4)


def test_woodbury_invalid_mode(monkeypatch):
    import jax
    from scipy import sparse

    from cymf_tpu import WMF
    from cymf_tpu.parallel import MeshContext, use_mesh
    monkeypatch.setenv("CYMF_TPU_ALS_WOODBURY", "maybe")
    X = sparse.random(50, 40, density=0.1, random_state=0, format="csr",
                      data_rvs=lambda n: np.ones(n))
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        with pytest.raises(ValueError, match="WOODBURY"):
            WMF(num_components=8).fit(X, num_epochs=1, verbose=False)


def test_woodbury_auto_guard_low_weight_decay(monkeypatch):
    """auto routing requires K >= 128, weight > 1, and weight_decay >=
    1e-3 (the explicit f32 A0 inverse degrades with cond(A0) ~
    ||YtY||/wd)."""
    monkeypatch.delenv("CYMF_TPU_ALS_CHOL", raising=False)
    X = sparse.random(60, 40, density=0.1, random_state=0, format="csr",
                      data_rvs=lambda n: np.ones(n))
    m = WMF(num_components=128, weight_decay=1e-4)
    m.fit(X, num_epochs=1, verbose=False)
    assert m.woodbury_max_p_ == 0  # low wd: conditioning guard
    m2 = WMF(num_components=128, weight_decay=0.01)
    m2.fit(X, num_epochs=1, verbose=False)
    # auto chol -> blocked at K=128 -> Woodbury cap P <= K/4
    assert m2.woodbury_max_p_ == 32
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "xla")
    m2b = WMF(num_components=128, weight_decay=0.01)
    m2b.fit(X, num_epochs=1, verbose=False)
    assert m2b.woodbury_max_p_ == 128  # vs XLA chol: wins through P<=K
    # blocked requested but cannot engage at this K (not divisible by
    # the block): the resolved name falls back to XLA and the cap must
    # follow the solver that actually runs
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "blocked")
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL_BLOCK", "96")
    m2c = WMF(num_components=128, weight_decay=0.01)
    m2c.fit(X, num_epochs=1, verbose=False)
    assert m2c.woodbury_max_p_ == 128
    monkeypatch.delenv("CYMF_TPU_ALS_CHOL")
    monkeypatch.delenv("CYMF_TPU_ALS_CHOL_BLOCK")
    m3 = WMF(num_components=128, weight=1.0)  # needs weight > 1
    m3.fit(X, num_epochs=1, verbose=False)
    assert m3.woodbury_max_p_ == 0
    m4 = WMF(num_components=64)  # K < 128: Cholesky is cheap, no route
    m4.fit(X, num_epochs=1, verbose=False)
    assert m4.woodbury_max_p_ == 0


def test_blocked_cholesky_matches_xla(monkeypatch):
    """The JAX-level blocked Cholesky is bit-comparable to the XLA
    Cholesky path and engages automatically at K >= 128."""
    from cymf_tpu.ops.als import _solve_spd_blocked, solve_spd

    rng = np.random.default_rng(5)
    for C, K in [(6, 256), (4, 128)]:
        X = rng.standard_normal((C, K, K)).astype(np.float32)
        A = X @ X.transpose(0, 2, 1) + np.eye(K, dtype=np.float32)
        b = rng.standard_normal((C, K)).astype(np.float32)
        ref = np.linalg.solve(A, b[..., None])[..., 0]
        for blk in (32, 64, 128):
            if K <= blk or K % blk:
                continue
            got = np.array(_solve_spd_blocked(
                __import__("jax").numpy.asarray(A),
                __import__("jax").numpy.asarray(b), blk))
            rel = np.abs(got - ref).max() / np.abs(ref).max()
            assert rel < 5e-4, (C, K, blk, rel)
    # auto routing engages the blocked path at K >= 128 and must agree
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "auto")
    got = np.array(solve_spd(__import__("jax").numpy.asarray(A),
                             __import__("jax").numpy.asarray(b)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-4
    # forced off: xla path still exact
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "xla")
    got = np.array(solve_spd(__import__("jax").numpy.asarray(A),
                             __import__("jax").numpy.asarray(b)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-4


def test_blocked_cholesky_invalid_mode(monkeypatch):
    import jax
    from cymf_tpu.ops.als import solve_spd
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "fast")
    A = jax.numpy.eye(128)[None] * 2.0
    b = jax.numpy.ones((1, 128))
    with pytest.raises(ValueError, match="ALS_CHOL"):
        solve_spd(A, b)


def test_wmf_fit_blocked_cholesky_matches(monkeypatch, data):
    """End-to-end WMF fit equality between the XLA and blocked Cholesky
    paths at K=128 (the auto threshold).  One epoch with a solid
    weight_decay: K=128 over-parameterizes this 90x70 fixture, so
    repeated sweeps amplify f32 solver round-off chaotically — the
    solve-level test above pins exactness; this one guards plumbing."""
    X = sparse.csr_matrix(data.train)

    def run(mode, n_dev=1):
        import jax

        from cymf_tpu.parallel import MeshContext, use_mesh
        monkeypatch.setenv("CYMF_TPU_ALS_CHOL", mode)
        monkeypatch.setenv("CYMF_TPU_ALS_WOODBURY", "off")
        np.random.seed(9)
        with use_mesh(MeshContext.create(jax.devices()[:n_dev])):
            m = WMF(num_components=128, chunk_size=64, weight_decay=1.0)
            m.fit(X, num_epochs=1, verbose=False)
            return m.W.copy(), m.H.copy()

    W_x, H_x = run("xla")
    W_b, H_b = run("blocked")
    np.testing.assert_allclose(W_b, W_x, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(H_b, H_x, rtol=2e-3, atol=2e-4)
    # sharded chunk solver with the blocked solver name (trace-time
    # routing inside parallel/shard_step.py::sharded_wmf_chunk)
    W8_b, H8_b = run("blocked", n_dev=8)
    np.testing.assert_allclose(W8_b, W_x, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(H8_b, H_x, rtol=2e-3, atol=2e-4)
