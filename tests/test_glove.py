"""GloVe tests: co-occurrence builder semantics, training convergence,
word2vec export (reference behavior at `/root/reference/cymf/glove.pyx`)."""

import numpy as np
import pytest
from scipy import sparse

from cymf_tpu.models.glove import GloVe
from cymf_tpu.dataset.text import read_text


def _toy_cooc(V=30, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((V, V))
    mask = rng.random((V, V)) < 0.2
    dense[mask] = rng.integers(1, 50, size=mask.sum())
    np.fill_diagonal(dense, 0)
    return sparse.csr_matrix(dense)


def test_glove_loss_decreases():
    X = _toy_cooc()
    np.random.seed(0)
    model = GloVe(num_components=8, learning_rate=0.05, batch_size=64)
    model.fit(X, num_epochs=1)
    first = model.last_loss
    model2 = GloVe(num_components=8, learning_rate=0.05, batch_size=64)
    np.random.seed(0)
    model2.fit(X, num_epochs=40)
    assert model2.last_loss < first
    assert model2.W.shape == (X.shape[0], 8)


def test_glove_reconstructs_log_counts():
    """After training, w_c.h_x + b_c + b_x should approximate log(count)."""
    X = _toy_cooc(V=20, seed=1)
    np.random.seed(1)
    model = GloVe(num_components=10, learning_rate=0.1, batch_size=128)
    model.fit(X, num_epochs=300)
    coo = X.tocoo()
    pred = (np.sum(model.W_central[coo.row] * model.W_context[coo.col],
                   axis=1) + model.bias[coo.row]
            + model.context_bias[coo.col])
    err = np.mean((pred - np.log(coo.data)) ** 2)
    assert err < 0.1, err


def test_glove_final_embedding_is_average():
    X = _toy_cooc(V=10, seed=2)
    model = GloVe(num_components=4, batch_size=32)
    model.fit(X, num_epochs=2)
    np.testing.assert_allclose(
        model.W, (model.W_central + model.W_context) / 2.0)


def test_glove_rejects_dense_input():
    model = GloVe()
    with pytest.raises(TypeError):
        model.fit(np.zeros((4, 4)), num_epochs=1)
    with pytest.raises(ValueError):
        model.fit(None, num_epochs=1)


def test_save_word2vec_format(tmp_path):
    X = _toy_cooc(V=6, seed=3)
    model = GloVe(num_components=3, batch_size=16)
    model.fit(X, num_epochs=1)
    i2w = {i: f"word{i}" for i in range(6)}
    out = tmp_path / "vectors.txt"
    model.save_word2vec_format(str(out), i2w)
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "6 3"
    parts = lines[1].split(" ")
    assert parts[0] == "word0"
    np.testing.assert_allclose([float(p) for p in parts[1:]], model.W[0])


def test_read_text_exact_semantics(tmp_path):
    """Hand-computed left-window 1/distance co-occurrence
    (glove.pyx:223-226), min_count filter and first-seen vocab order
    (glove.pyx:205-219)."""
    corpus = tmp_path / "corpus.txt"
    # 'a' x4, 'b' x3, 'c' x1 -> with min_count=2, vocab = {a:0, b:1}
    corpus.write_text("a b a c\nb a b a")
    X, i2w = read_text(str(corpus), min_count=2, window_size=2)
    assert i2w == {0: "a", 1: "b"}
    # line 1 tokens: a b a  (c filtered) -> pairs (center j, context k):
    #   j=1(b): k=0(a) dist1 -> (b,a)+=1
    #   j=2(a): k=0(a) dist2 -> (a,a)+=0.5 ; k=1(b) dist1 -> (a,b)+=1
    # line 2 tokens: b a b a:
    #   j=1(a): (a,b)+=1
    #   j=2(b): (b,b)+=0.5 ; (b,a)+=1
    #   j=3(a): (a,a)+=0.5 ; (a,b)+=1
    want = np.asarray([[1.0, 3.0], [2.0, 0.5]])
    np.testing.assert_allclose(X.toarray(), want)


def test_read_text_window_weighting(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text("x y z x y z x y z")
    X, i2w = read_text(str(corpus), min_count=1, window_size=10)
    assert set(i2w.values()) == {"x", "y", "z"}
    # symmetry is NOT expected (left window only)
    assert X.toarray().sum() > 0
    # total weight = sum over pairs 1/dist for the 9-token line
    n = 9
    total = sum(1.0 / (j - k) for j in range(n)
                for k in range(max(0, j - 10), j))
    assert X.toarray().sum() == pytest.approx(total)


def test_native_cooccurrence_matches_python(tmp_path):
    """C++ accumulator must agree exactly with the numpy fallback."""
    import numpy as np
    from cymf_tpu.dataset.text import _python_cooccurrence
    from cymf_tpu import native as native_mod
    if not native_mod.HAVE_NATIVE:
        pytest.skip("native extension not built")
    rng = np.random.default_rng(0)
    lines = [rng.integers(0, 40, size=rng.integers(0, 60)).tolist()
             for _ in range(50)]
    kp, vp = _python_cooccurrence(lines, 40, 7)
    kn, vn = native_mod.cooccurrence(lines, 40, 7)
    order = np.argsort(kn)
    np.testing.assert_array_equal(kp, kn[order])
    np.testing.assert_allclose(vp, vn[order], rtol=1e-12)


def test_glove_checkpoint_resume(tmp_path):
    X = _toy_cooc(V=12, seed=5)
    p = str(tmp_path / "g.npz")
    np.random.seed(9)
    m1 = GloVe(num_components=4, batch_size=32)
    m1.fit(X, num_epochs=6)

    np.random.seed(9)
    m2 = GloVe(num_components=4, batch_size=32)
    m2.fit(X, num_epochs=3, checkpoint_path=p)
    np.random.seed(9)
    m3 = GloVe(num_components=4, batch_size=32)
    m3.fit(X, num_epochs=6, checkpoint_path=p, resume=True)
    # shuffle order differs between m1 (one shuffle draw after seed) and
    # m3 (fresh shuffle) — wait: both seed np with 9 then init draws then
    # shuffle; identical streams, so full parity is expected
    np.testing.assert_allclose(m3.W, m1.W, rtol=1e-4, atol=1e-6)


def test_glove_bias_modes_equivalent_quality():
    """fused (paper-rule) and kfold (reference-quirk) bias modes both
    reconstruct log-counts to similar quality."""
    X = _toy_cooc(V=20, seed=7)
    errs = {}
    for mode in ("fused", "kfold"):
        np.random.seed(7)
        m = GloVe(num_components=10, learning_rate=0.1, batch_size=128,
                  bias_mode=mode)
        m.fit(X, num_epochs=200)
        coo = X.tocoo()
        pred = (np.sum(m.W_central[coo.row] * m.W_context[coo.col], axis=1)
                + m.bias[coo.row] + m.context_bias[coo.col])
        errs[mode] = np.mean((pred - np.log(coo.data)) ** 2)
    assert errs["fused"] < 0.15, errs
    assert errs["kfold"] < 0.15, errs


def test_glove_invalid_bias_mode():
    with pytest.raises(ValueError):
        GloVe(bias_mode="magic")
