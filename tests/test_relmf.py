"""RelMF tests: single-step gradient parity against hand-computed updates of
the reference equations (`/root/reference/cymf/model.pyx:99-142`), plus
convergence."""

import numpy as np
import pytest
from scipy import sparse

from cymf_tpu import AoaEvaluator, RelMF
from cymf_tpu.dataset import SyntheticImplicitDataset


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=100, num_item=60, rank=4,
                                    density=0.15, seed=5)


def test_relmf_propensity_formula(data):
    """p_i = max(colmean / max_colmean, 1e-5)^0.5 (relmf.pyx:88)."""
    X = sparse.csr_matrix(data.train).astype(np.float64)
    col_mean = np.asarray(X.mean(axis=0)).flatten()
    want = np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5
    assert want.max() == pytest.approx(1.0)
    assert (want > 0).all()


def test_relmf_learns_ranking(data):
    ev = AoaEvaluator(data.test, data.train, metrics=["DCG"], k=5)
    model = RelMF(num_components=8, learning_rate=0.02, clip_value=0.1,
                  weight_decay=1e-4, batch_size=2048)
    model.fit(data.train, num_epochs=2, verbose=False)
    before = ev.evaluate(model.W, model.H)["DCG@5"]
    model.fit(data.train, num_epochs=30, verbose=False)
    after = ev.evaluate(model.W, model.H)["DCG@5"]
    assert after > before, (before, after)
    assert after > 0.15


def test_relmf_loss_decreases(data):
    model = RelMF(num_components=8, learning_rate=0.02, batch_size=2048)
    model.fit(data.train, num_epochs=1, verbose=False)
    first = model.last_loss
    model.fit(data.train, num_epochs=25, verbose=False)
    assert model.last_loss < first


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_relmf_optimizers_finite(data, opt):
    model = RelMF(num_components=4, learning_rate=0.01, optimizer=opt,
                  batch_size=1024)
    model.fit(data.train, num_epochs=2, verbose=False)
    assert np.all(np.isfinite(model.W))
    assert np.all(np.isfinite(model.H))


def test_relmf_early_stopping(data):
    ev = AoaEvaluator(data.valid, data.train, metrics=["DCG"], k=5)
    model = RelMF(num_components=8, learning_rate=0.02, batch_size=2048)
    model.fit(data.train, num_epochs=40, valid_evaluator=ev,
              early_stopping=True, verbose=False)
    restored = ev.evaluate(model.W, model.H)["DCG@5"]
    assert restored == pytest.approx(model.valid_dcg, abs=1e-6)


def test_relmf_invalid_optimizer():
    with pytest.raises(Exception):
        RelMF(optimizer="nope")


def test_chunked_epoch_matches_monolithic():
    """A chunked RelMF epoch (two scans with step offsets) is bitwise-
    identical to the monolithic scan — the chunk boundary must not
    perturb the per-step RNG stream (models/relmf.py::_relmf_epoch)."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.models.relmf import _relmf_epoch_jit
    from cymf_tpu.ops.hashset import build_pair_hashset

    U, I, K, B = 60, 40, 6, 128
    rng = np.random.default_rng(0)
    rows = rng.integers(0, U, 200).astype(np.int32)
    cols = rng.integers(0, I, 200).astype(np.int32)
    hs = build_pair_hashset(rows, cols)
    props = jnp.asarray(rng.uniform(0.2, 1.0, (I, 1)).astype(np.float32))
    W0 = jnp.asarray(rng.normal(size=(U, K)).astype(np.float32) * 0.01)
    H0 = jnp.asarray(rng.normal(size=(I, K)).astype(np.float32) * 0.01)
    key = jax.random.PRNGKey(3)

    def run(chunks):
        # fresh copies: the epoch jit donates its table/state args
        W, H = jnp.array(W0), jnp.array(H0)
        ow = oh = None
        loss = 0.0
        off = 0
        for n in chunks:
            o, fn = _relmf_epoch_jit("adam", 0.01, 0.01, 0.1, U, I, n, B,
                                     "dense", True)
            if ow is None:
                ow, oh = o.init(W), o.init(H)
            W, H, ow, oh, l = fn(W, H, ow, oh, hs, props, key,
                                 jnp.asarray(off, jnp.int32))
            loss += float(l)
            off += n
        return np.asarray(W), np.asarray(H), loss

    Wm, Hm, lm = run([8])
    Wc, Hc, lc = run([5, 3])
    np.testing.assert_array_equal(Wc, Wm)
    np.testing.assert_array_equal(Hc, Hm)
    assert lc == pytest.approx(lm, rel=1e-6)
