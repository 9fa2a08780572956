"""Multi-device semantics: training on an 8-device mesh must match
single-device training (synchronous SPMD has no Hogwild-style
nondeterminism — determinism is a test asset, SURVEY.md §5)."""

import jax
import numpy as np
import pytest

from cymf_tpu import BPR, WMF
from cymf_tpu.dataset import SyntheticImplicitDataset
from cymf_tpu.parallel import MeshContext, use_mesh


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=96, num_item=64, rank=4,
                                    density=0.15, seed=13)


def _fit_bpr(data, devices):
    with use_mesh(MeshContext.create(devices)):
        m = BPR(num_components=8, learning_rate=0.02, batch_size=128)
        m.fit(data.train, num_epochs=5, verbose=False, seed=3)
        return m.W.copy(), m.H.copy()


def test_bpr_same_result_1dev_vs_8dev(data):
    W1, H1 = _fit_bpr(data, jax.devices()[:1])
    W8, H8 = _fit_bpr(data, jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(H8, H1, rtol=2e-3, atol=2e-5)


def test_wmf_same_result_1dev_vs_8dev(data):
    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            m = WMF(num_components=8, chunk_size=32)
            m.fit(data.train, num_epochs=2, verbose=False)
            return m.W.copy(), m.H.copy()

    W1, H1 = run(jax.devices()[:1])
    W8, H8 = run(jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(H8, H1, rtol=2e-3, atol=2e-5)


def test_graft_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(len(jax.devices()))


def test_graft_entry_compiles():
    """entry() is one epoch of the XLA BPR engine: it returns the updated
    tables, optimizer state and the mean loss."""
    import __graft_entry__ as g
    fn, args = g.entry()
    W, H, _, _, loss = jax.jit(fn)(*args)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(W)).all()
    assert W.shape == args[0].shape and H.shape == args[1].shape


def test_relmf_same_result_1dev_vs_8dev(data):
    from cymf_tpu import RelMF

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            m = RelMF(num_components=6, batch_size=256)
            m.fit(data.train, num_epochs=2, verbose=False, seed=5)
            return m.W.copy()

    W1 = run(jax.devices()[:1])
    W8 = run(jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)


def test_glove_same_result_1dev_vs_8dev():
    from scipy import sparse
    from cymf_tpu import GloVe
    rng = np.random.default_rng(4)
    dense = np.triu(rng.integers(0, 20, (24, 24))
                    * (rng.random((24, 24)) < 0.3))
    X = sparse.csr_matrix(dense)

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            np.random.seed(11)
            m = GloVe(num_components=8, batch_size=64)
            m.fit(X, num_epochs=5)
            return m.W.copy()

    W1 = run(jax.devices()[:1])
    W8 = run(jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)


def test_evaluator_sharded_matches_single_device():
    """Sharded evaluation (users partitioned over the mesh) must equal the
    single-device result when metrics are insensitive to which negatives
    were drawn (every positive outscores every negative by construction);
    the per-device negative streams differ, the metrics must not."""
    from scipy import sparse

    from cymf_tpu.evaluation.evaluator import Evaluator

    rng = np.random.default_rng(5)
    U, I, K = 100, 60, 6
    X_test = sparse.random(U, I, density=0.05, random_state=2, format="csr",
                           data_rvs=lambda n: np.ones(n))
    X_train = sparse.random(U, I, density=0.1, random_state=3, format="csr",
                            data_rvs=lambda n: np.ones(n))
    W = rng.normal(size=(U, K))
    # all-ties scores: stable top-k ranks candidates in list order, i.e.
    # positives first — every metric becomes a deterministic function of
    # the per-user positive count, independent of the negative draws
    H = np.zeros((I, K))

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            ev = Evaluator(X_test, X_train, k=[1, 5], num_negatives=20)
            return ev.evaluate(W, H, seed=11)

    r1 = run(jax.devices()[:1])
    r8 = run(jax.devices())
    assert r1.keys() == r8.keys()
    for key in r1:
        np.testing.assert_allclose(r8[key], r1[key], rtol=1e-6, atol=1e-7)


def test_recommend_sharded_matches_single_device():
    """The distributed top-k (H row-sharded, per-shard top-k + merge) is
    bitwise-identical to the single-device full-row top-k, including
    exclusion masking and non-divisible catalog padding."""
    from scipy import sparse

    from cymf_tpu import recommend

    rng = np.random.default_rng(7)
    W = rng.normal(size=(37, 5))
    H = rng.normal(size=(53, 5))  # not divisible by 8 -> padded shards
    X = sparse.random(37, 53, density=0.2, random_state=1, format="csr",
                      data_rvs=lambda n: np.ones(n))

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            return recommend(W, H, k=7, exclude=X)

    s1, i1 = run(jax.devices()[:1])
    s8, i8 = run(jax.devices())
    np.testing.assert_array_equal(i8, i1)
    # score values may differ in the last ulp (different matmul shapes
    # compile to different reduction schedules); ranking must not
    np.testing.assert_allclose(s8, s1, rtol=1e-6)


def test_bpr_medium_shape_nondivisible_1dev_vs_8dev():
    """Medium-shape mesh run (thousands of rows, non-divisible by the
    device count everywhere: users, items, and batch) — the tiny-shape
    equality tests can't catch padding/donation bugs that only appear
    when shard boundaries fall mid-table."""
    d = SyntheticImplicitDataset(num_user=5003, num_item=2001, rank=6,
                                 density=0.005, seed=21)

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            m = BPR(num_components=12, learning_rate=0.02,
                    batch_size=4096)
            m.fit(d.train, num_epochs=3, verbose=False, seed=9)
            return m.W.copy(), m.H.copy()

    W1, H1 = run(jax.devices()[:1])
    W8, H8 = run(jax.devices())
    assert W1.shape == (5003, 12) and H1.shape == (2001, 12)
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(H8, H1, rtol=2e-3, atol=2e-5)


def test_evaluator_sharded_medium_nondivisible():
    """Sharded evaluator at a user count that leaves a ragged last
    shard (1003 users over 8 devices) with mixed user degrees."""
    from scipy import sparse

    from cymf_tpu.evaluation.evaluator import Evaluator

    rng = np.random.default_rng(17)
    U, I, K = 1003, 517, 8
    X_test = sparse.random(U, I, density=0.02, random_state=4,
                           format="csr", data_rvs=lambda n: np.ones(n))
    X_train = sparse.random(U, I, density=0.05, random_state=5,
                            format="csr", data_rvs=lambda n: np.ones(n))
    W = rng.normal(size=(U, K))
    H = np.zeros((I, K))  # all-ties: metrics independent of neg draws

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            ev = Evaluator(X_test, X_train, k=[1, 5], num_negatives=30)
            return ev.evaluate(W, H, seed=2)

    r1 = run(jax.devices()[:1])
    r8 = run(jax.devices())
    for key in r1:
        np.testing.assert_allclose(r8[key], r1[key], rtol=1e-6, atol=1e-7)


def test_expomf_same_result_1dev_vs_8dev(data):
    from cymf_tpu import ExpoMF

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            m = ExpoMF(num_components=8, chunk_size=32)
            m.fit(data.train, num_epochs=2, verbose=False)
            return m.W.copy(), m.H.copy(), m.mu.copy()

    W1, H1, mu1 = run(jax.devices()[:1])
    W8, H8, mu8 = run(jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(H8, H1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(mu8, mu1, rtol=2e-3, atol=2e-6)


def test_expomf_nondivisible_shapes_1dev_vs_8dev():
    """Rows/items NOT multiples of the device count: table padding, chunk
    sentinel padding and the mu column mask must all compose."""
    from cymf_tpu import ExpoMF
    d = SyntheticImplicitDataset(num_user=101, num_item=67, rank=4,
                                 density=0.15, seed=5)

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            m = ExpoMF(num_components=8, chunk_size=24)
            m.fit(d.train, num_epochs=2, verbose=False)
            return m.W.copy(), m.H.copy(), m.mu.copy()

    W1, H1, mu1 = run(jax.devices()[:1])
    W8, H8, mu8 = run(jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(H8, H1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(mu8, mu1, rtol=2e-3, atol=2e-6)


def test_glove_kfold_same_result_1dev_vs_8dev():
    """The reference-exact kfold bias mode through its explicit
    shard_map epoch must equal single-device training."""
    from scipy import sparse
    from cymf_tpu import GloVe
    rng = np.random.default_rng(4)
    dense = np.triu(rng.integers(0, 20, (24, 24))
                    * (rng.random((24, 24)) < 0.3))
    X = sparse.csr_matrix(dense)

    def run(devices):
        with use_mesh(MeshContext.create(devices)):
            np.random.seed(11)
            m = GloVe(num_components=8, batch_size=64, bias_mode="kfold")
            m.fit(X, num_epochs=5)
            return m.W.copy(), m.bias.copy()

    W1, b1 = run(jax.devices()[:1])
    W8, b8 = run(jax.devices())
    np.testing.assert_allclose(W8, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(b8, b1, rtol=2e-3, atol=2e-5)
