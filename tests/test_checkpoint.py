"""Checkpoint/resume tests: save + restore pytrees, and mid-fit resume
producing the same result as an uninterrupted run, for ALL five models."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse

from cymf_tpu import BPR, WMF, RelMF, ExpoMF, GloVe
from cymf_tpu.dataset import SyntheticImplicitDataset
from cymf_tpu.utils.checkpoint import load_checkpoint, save_checkpoint


def test_save_load_roundtrip(tmp_path):
    state = {"W": jnp.arange(12.0).reshape(3, 4),
             "opt": {"m": jnp.ones((3, 4)), "v": jnp.zeros((3, 4))}}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, epoch=7, meta={"lr": 0.01})
    loaded, epoch, meta = load_checkpoint(p, state)
    assert epoch == 7
    assert float(meta["lr"]) == pytest.approx(0.01)
    np.testing.assert_allclose(np.asarray(loaded["W"]),
                               np.asarray(state["W"]))
    np.testing.assert_allclose(np.asarray(loaded["opt"]["v"]), 0.0)


def test_load_missing_leaf_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, {"a": jnp.zeros(2)}, epoch=0)
    with pytest.raises(KeyError):
        load_checkpoint(p, {"a": jnp.zeros(2), "b": jnp.zeros(3)})


def test_async_checkpointer_matches_sync(tmp_path):
    """AsyncCheckpointer.save + wait yields a file byte-equivalent in
    content to the sync writer; the snapshot is of save-time state even
    if the caller mutates afterwards; write errors surface on wait()."""
    from cymf_tpu.utils.checkpoint import AsyncCheckpointer

    state = {"W": jnp.arange(12.0).reshape(3, 4),
             "opt": {"m": jnp.ones((3, 4))}}
    pa = str(tmp_path / "async.npz")
    ps = str(tmp_path / "sync.npz")
    ck = AsyncCheckpointer()
    ck.save(pa, state, epoch=3, meta={"lr": 0.5})
    # mutate the live dict AFTER save: the snapshot must not see it
    state["W"] = state["W"] + 100.0
    ck.wait()
    save_checkpoint(ps, {"W": jnp.arange(12.0).reshape(3, 4),
                         "opt": {"m": jnp.ones((3, 4))}}, epoch=3,
                    meta={"lr": 0.5})
    la, ea, ma = load_checkpoint(pa, state)
    ls, es, ms = load_checkpoint(ps, state)
    assert ea == es == 3 and float(ma["lr"]) == float(ms["lr"]) == 0.5
    np.testing.assert_array_equal(np.asarray(la["W"]), np.asarray(ls["W"]))
    np.testing.assert_array_equal(np.asarray(la["opt"]["m"]),
                                  np.asarray(ls["opt"]["m"]))

    bad = AsyncCheckpointer()
    bad.save("/proc/definitely/not/writable/x.npz", state, epoch=0)
    with pytest.raises(OSError):
        bad.wait()


def test_bpr_resume_matches_uninterrupted(tmp_path):
    data = SyntheticImplicitDataset(num_user=80, num_item=50, rank=4,
                                    density=0.15, seed=4)
    kw = dict(num_components=6, learning_rate=0.02, batch_size=128)
    p = str(tmp_path / "bpr.npz")

    # uninterrupted: 6 epochs
    m1 = BPR(**kw)
    m1.fit(data.train, num_epochs=6, verbose=False, seed=7)

    # interrupted: 3 epochs w/ checkpoint, then resume to 6
    m2 = BPR(**kw)
    m2.fit(data.train, num_epochs=3, verbose=False, seed=7,
           checkpoint_path=p)
    m3 = BPR(**kw)
    m3.fit(data.train, num_epochs=6, verbose=False, seed=7,
           checkpoint_path=p, resume=True)

    # identical modulo the epoch-3 restart of the shuffled order (we reuse
    # the same seed so the shuffle and negative streams are identical)
    np.testing.assert_allclose(m3.W, m1.W, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(m3.H, m1.H, rtol=1e-4, atol=1e-6)


def _make_model(name):
    if name == "bpr":
        return BPR(num_components=6, learning_rate=0.02, batch_size=128)
    if name == "relmf":
        return RelMF(num_components=6, learning_rate=0.02, batch_size=512)
    if name == "wmf":
        return WMF(num_components=6)
    if name == "expomf":
        return ExpoMF(num_components=6)
    if name == "glove":
        return GloVe(num_components=6, learning_rate=0.05, batch_size=128)
    raise ValueError(name)


def _fit_data(name, seed=4):
    if name == "glove":
        rng = np.random.default_rng(seed)
        V = 40
        dense = (rng.random((V, V)) < 0.2) * rng.integers(1, 20, (V, V))
        np.fill_diagonal(dense, 0)
        return sparse.csr_matrix(dense.astype(np.float64))
    data = SyntheticImplicitDataset(num_user=80, num_item=50, rank=4,
                                    density=0.15, seed=seed)
    return data.train


@pytest.mark.parametrize("name", ["bpr", "relmf", "wmf", "expomf", "glove"])
def test_resume_matches_uninterrupted(tmp_path, name):
    """Resume == uninterrupted for all 5 models."""
    X = _fit_data(name)
    p = str(tmp_path / f"{name}.npz")

    # model inits that read the ambient numpy stream (GloVe) must be pinned
    np.random.seed(99)
    m1 = _make_model(name)
    m1.fit(X, num_epochs=6, verbose=False, checkpoint_path=None)

    np.random.seed(99)
    m2 = _make_model(name)
    m2.fit(X, num_epochs=3, verbose=False, checkpoint_path=p)
    np.random.seed(99)
    m3 = _make_model(name)
    m3.fit(X, num_epochs=6, verbose=False, checkpoint_path=p, resume=True)

    np.testing.assert_allclose(m3.W, m1.W, rtol=1e-4, atol=1e-4)
    if name == "glove":
        np.testing.assert_allclose(m3.W_context, m1.W_context,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(m3.bias, m1.bias, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(m3.H, m1.H, rtol=1e-4, atol=1e-4)
    if name == "expomf":
        np.testing.assert_allclose(m3.mu, m1.mu, rtol=1e-4, atol=1e-4)


def test_bpr_resume_across_row_padding(tmp_path):
    """A checkpoint whose leaves carry a different row padding (written
    under another mesh/device count) resumes: tables AND optimizer
    leaves slice-and-repad instead of erroring."""
    X = sparse.random(120, 70, density=0.2, random_state=3, format="csr")
    X.data[:] = 1.0
    kw = dict(num_components=6, learning_rate=0.02, batch_size=128,
              optimizer="adam")
    p = str(tmp_path / "ck.npz")
    m1 = BPR(**kw)
    m1.fit(X, num_epochs=2, verbose=False, seed=7, checkpoint_path=p)

    m2 = BPR(**kw)
    m2.fit(X, num_epochs=3, verbose=False, seed=7, checkpoint_path=str(
        tmp_path / "c2.npz"), resume=False)

    # simulate a foreign row padding: 64 extra zero rows on every leaf
    with np.load(p) as z:
        flat = {k: z[k] for k in z.files}
    for k, v in list(flat.items()):
        if v.ndim == 2:
            flat[k] = np.pad(v, ((0, 64), (0, 0)))
    np.savez(p, **flat)

    m3 = BPR(**kw)
    m3.fit(X, num_epochs=3, verbose=False, seed=7, checkpoint_path=p,
           resume=True)
    # epoch 3 trained through the repadded moments identically to an
    # uninterrupted 3-epoch run
    np.testing.assert_allclose(m3.W, m2.W, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m3.H, m2.H, rtol=1e-5, atol=1e-6)


def test_load_shape_mismatch_raises(tmp_path):
    """Schema drift (a leaf stored under a different shape) fails loudly
    instead of silently carrying mismatched arrays."""
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, {"b": jnp.zeros((1, 1))}, epoch=0)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, {"b": jnp.zeros((1,))})


@pytest.mark.parametrize("src,dst", [(1, 4), (4, 1)])
@pytest.mark.parametrize("name", ["bpr", "relmf", "wmf", "expomf", "glove"])
def test_resume_across_device_count(tmp_path, name, src, dst):
    """A checkpoint written on one mesh resumes on another: the row
    padding of every table and optimizer leaf differs (50 items pad to
    52 on 4 devices) and is sliced or extended on load."""
    import jax

    from cymf_tpu.parallel import MeshContext, use_mesh

    X = _fit_data(name)
    if name == "glove":
        X = X[:42, :42]
    p = str(tmp_path / f"{name}.npz")

    def fit(n_dev, epochs, **kw):
        np.random.seed(99)
        with use_mesh(MeshContext.create(jax.devices()[:n_dev])):
            m = _make_model(name)
            m.fit(X, num_epochs=epochs, verbose=False, **kw)
        return m

    ref = fit(dst, 4)
    fit(src, 2, checkpoint_path=p)
    got = fit(dst, 4, checkpoint_path=p, resume=True)
    np.testing.assert_allclose(got.W, ref.W, rtol=1e-4, atol=1e-4)
    if name == "glove":
        np.testing.assert_allclose(got.bias, ref.bias, rtol=1e-4,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(got.H, ref.H, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("name", ["bpr", "relmf", "wmf", "expomf", "glove"])
def test_resume_for_another_matrix_raises(tmp_path, name, n_dev):
    """A checkpoint written for a matrix with one more row (users, or
    words for GloVe) does not resume: its real row count differs, even
    where the padded shapes agree (80 and 79 users both pad to 80 on 4
    devices)."""
    import jax

    from cymf_tpu.parallel import MeshContext, use_mesh

    X = _fit_data(name)
    if name == "glove":
        X = X[:42, :42]
    small = X[:-1, :-1] if name == "glove" else X[:-1]
    p = str(tmp_path / f"{name}.npz")
    with use_mesh(MeshContext.create(jax.devices()[:n_dev])):
        np.random.seed(99)
        _make_model(name).fit(X, num_epochs=1, verbose=False,
                              checkpoint_path=p)
        np.random.seed(99)
        with pytest.raises(ValueError, match="another matrix"):
            _make_model(name).fit(small, num_epochs=2, verbose=False,
                                  checkpoint_path=p, resume=True)


def test_load_checks_recorded_rows(tmp_path):
    """Row padding may differ only where both sides record the real rows,
    and only in padding rows."""
    p = str(tmp_path / "ck.npz")
    W = np.arange(12.0).reshape(6, 2)
    save_checkpoint(p, {"W": W}, epoch=3, rows={"W": 5})
    like = {"W": jnp.full((8, 2), -1.0)}
    state, epoch, meta = load_checkpoint(p, like, rows={"W": 5})
    np.testing.assert_array_equal(np.asarray(state["W"])[:5], W[:5])
    np.testing.assert_array_equal(np.asarray(state["W"])[5:], -1.0)
    assert epoch == 3 and meta == {}
    with pytest.raises(ValueError, match="another matrix"):
        load_checkpoint(p, {"W": jnp.zeros((6, 2))}, rows={"W": 6})
    with pytest.raises(ValueError, match="padding rows"):
        load_checkpoint(p, like)  # no real count to check against
    q = str(tmp_path / "legacy.npz")
    save_checkpoint(q, {"W": W}, epoch=0)  # no rows recorded
    with pytest.raises(ValueError, match="padding rows"):
        load_checkpoint(q, like, rows={"W": 5})
