"""Evaluator tests: against a straightforward numpy reimplementation of the
reference evaluation protocol (`/root/reference/cymf/evaluator.pyx:57-139`)
on small synthetic data, plus structural invariants."""

import numpy as np
import pytest
from scipy import sparse

from cymf_tpu.evaluation import metrics as M
from cymf_tpu.evaluation.evaluator import (AoaEvaluator, Evaluator,
                                           UnbiasedEvaluator)


def _toy_data(seed=0, U=30, I=40, density=0.15):
    rng = np.random.default_rng(seed)
    X_test = sparse.random(U, I, density=density, random_state=seed,
                           format="csr", data_rvs=lambda n: np.ones(n))
    X_train = sparse.random(U, I, density=density, random_state=seed + 1,
                            format="csr", data_rvs=lambda n: np.ones(n))
    W = rng.normal(size=(U, 8))
    H = rng.normal(size=(I, 8))
    return X_test, X_train, W, H


def _numpy_reference_eval(X_test, X_train, W, H, k, num_negatives, seed,
                          unbiased=False):
    """Per-user loop replicating evaluator.pyx semantics with numpy RNG
    (RNG stream differs from mt19937, so comparisons are statistical)."""
    U, I = X_test.shape
    rng = np.random.default_rng(seed)
    user_pos = (X_test + X_train).tocsr()
    props = np.maximum(np.asarray(X_test.mean(axis=0)).flatten(), 1e-4)
    vals = {m: np.zeros(U) for m in ("DCG", "Recall", "MAP")}
    for u in range(U):
        test_items = X_test[u].indices
        if len(test_items) == 0:
            continue
        pos_set = set(user_pos[u].indices)
        negs = []
        while len(negs) < num_negatives:
            c = rng.integers(0, I)
            if c not in pos_set:
                negs.append(c)
        items = np.concatenate([test_items, negs]).astype(int)
        labels = np.concatenate(
            [np.ones(len(test_items), int), np.zeros(num_negatives, int)])
        scores = H[items] @ W[u]
        order = np.argsort(-scores)
        y = labels[order]
        p = props[items][order]
        if unbiased:
            vals["DCG"][u] = M.dcg_at_k_with_ips(y, p, k)
            vals["Recall"][u] = M.recall_at_k_with_ips(y, p, k)
            vals["MAP"][u] = M.average_precision_at_k_with_ips(y, p, k)
        else:
            vals["DCG"][u] = M.dcg_at_k(y, k)
            vals["Recall"][u] = M.recall_at_k(y, k)
            vals["MAP"][u] = M.average_precision_at_k(y, k)
    return {f"{m}@{k}": v.mean() for m, v in vals.items()}


@pytest.mark.parametrize("unbiased", [False, True])
def test_evaluator_statistical_parity_with_reference_protocol(unbiased):
    X_test, X_train, W, H = _toy_data()
    ev = Evaluator(X_test, X_train, k=5, num_negatives=100,
                   unbiased=unbiased)
    got = [ev.evaluate(W, H, seed=s) for s in range(3)]
    want = [_numpy_reference_eval(X_test, X_train, W, H, 5, 100, s,
                                  unbiased) for s in range(3)]
    for key in got[0]:
        g = np.mean([r[key] for r in got])
        w = np.mean([r[key] for r in want])
        assert abs(g - w) < 0.05, (key, g, w)


def test_perfect_model_scores_high():
    """A model that scores exactly the test labels should be near-perfect."""
    U, I = 16, 30
    rng = np.random.default_rng(3)
    dense = (rng.random((U, I)) < 0.1).astype(float)
    dense[:, 0] = 1.0  # ensure every user has a positive
    X_test = sparse.csr_matrix(dense)
    # rank-I factorization reproducing the dense matrix exactly
    W = dense
    H = np.eye(I)
    ev = Evaluator(X_test, None, k=100, num_negatives=50)
    res = ev.evaluate(W, H)
    # with k=100 >= list length every positive is recalled; score margin 1>0
    assert res["Recall@100"] == pytest.approx(1.0)


def test_users_without_test_positives_count_as_zero():
    """Mean is over ALL users; users w/o test positives contribute 0
    (evaluator.pyx:91-92 + zeros init)."""
    U, I = 10, 20
    dense = np.zeros((U, I))
    dense[0, :5] = 1.0  # only user 0 has test positives
    X_test = sparse.csr_matrix(dense)
    W = np.ones((U, 4))
    H = np.ones((I, 4))
    ev = Evaluator(X_test, None, k=5, num_negatives=10)
    res = ev.evaluate(W, H)
    assert 0.0 < res["Recall@5"] <= 1.0 / U + 1e-9


def test_k_list_and_key_format():
    X_test, X_train, W, H = _toy_data()
    ev = AoaEvaluator(X_test, X_train, k=[1, 5])
    res = ev.evaluate(W, H)
    assert set(res) == {"DCG@1", "Recall@1", "MAP@1",
                        "DCG@5", "Recall@5", "MAP@5"}


def test_unbiased_evaluator_subclass():
    X_test, X_train, W, H = _toy_data()
    ev = UnbiasedEvaluator(X_test, X_train, k=5)
    res = ev.evaluate(W, H)
    assert all(np.isfinite(v) for v in res.values())


def test_negatives_never_collide_with_positives():
    """All-but-one items positive: the single valid negative must be picked."""
    U, I = 4, 12
    dense = np.ones((U, I))
    dense[:, 3] = 0.0
    X_test = sparse.csr_matrix(dense)
    W = np.ones((U, 2))
    H = np.zeros((I, 2))
    H[3] = -100.0  # item 3 (the only possible negative) scores lowest
    ev = Evaluator(X_test, None, k=I, num_negatives=8)
    res = ev.evaluate(W, H)
    # every positive ranks above every sampled negative -> perfect recall
    assert res[f"Recall@{I}"] == pytest.approx(1.0)


def test_exact_negative_count_on_dense_matrix():
    """The reference rejection-samples *until* it has
    exactly num_negatives valid negatives (evaluator.pyx:106-111).  On a 90%-
    dense positive matrix a single oversampled draw would fall short; the
    refill loop must deliver the exact count, all non-positive."""
    import jax

    from cymf_tpu.evaluation.evaluator import draw_negatives
    from cymf_tpu.ops.hashset import build_pair_hashset

    U, I = 8, 200
    rng = np.random.default_rng(0)
    dense = (rng.random((U, I)) < 0.9).astype(float)
    X = sparse.csr_matrix(dense)
    coo = X.tocoo()
    hs = build_pair_hashset(coo.row, coo.col)
    users = np.arange(U, dtype=np.int32)
    neg, valid = jax.device_get(draw_negatives(
        users, hs, jax.random.PRNGKey(0), I, 100))
    assert valid.all(), "every user must receive exactly num_negatives"
    for u in range(U):
        pos = set(X[u].indices.tolist())
        assert not (set(neg[u].tolist()) & pos), "negatives must avoid positives"


def test_dense_user_metrics_not_inflated():
    """End-to-end: with exact negative counts, a heavy user's candidate list
    is as hard as the reference's — Recall@5 on a bad model stays low."""
    U, I = 6, 300
    rng = np.random.default_rng(1)
    dense = (rng.random((U, I)) < 0.85).astype(float)
    dense[:, 0] = 1.0
    X_test = sparse.csr_matrix(dense)
    W = rng.normal(size=(U, 4))
    H = rng.normal(size=(I, 4))
    ev = Evaluator(X_test, None, k=5, num_negatives=100)
    res = ev.evaluate(W, H)
    assert np.isfinite(list(res.values())).all()


def test_evaluator_zero_negatives():
    """num_negatives=0: candidates are the test positives only."""
    X_test, X_train, W, H = _toy_data()
    ev = Evaluator(X_test, X_train, k=5, num_negatives=0)
    res = ev.evaluate(W, H)
    # with positives only, every top-k slot is a positive
    assert res["Recall@5"] > 0
    assert np.isfinite(list(res.values())).all()


def test_evaluator_single_user():
    dense = np.zeros((1, 10))
    dense[0, [1, 4]] = 1.0
    ev = Evaluator(sparse.csr_matrix(dense), None, k=2, num_negatives=5)
    rng = np.random.default_rng(0)
    res = ev.evaluate(rng.normal(size=(1, 3)), rng.normal(size=(10, 3)))
    assert np.isfinite(list(res.values())).all()
