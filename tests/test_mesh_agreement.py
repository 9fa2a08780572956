"""1-device vs 2- and 4-device meshes: every trainer, the evaluator and
``recommend`` give the single-device result up to float summation order
(the sharded paths draw the single-device random streams)."""

import jax
import numpy as np
import pytest
from scipy import sparse

from cymf_tpu import (BPR, WMF, AoaEvaluator, ExpoMF, GloVe, RelMF,
                      recommend)
from cymf_tpu.dataset import SyntheticImplicitDataset
from cymf_tpu.parallel import MeshContext, use_mesh


@pytest.fixture(scope="module")
def data():
    # 77 users x 51 items: neither divides by 2 or 4 (padded shards)
    return SyntheticImplicitDataset(num_user=77, num_item=51, rank=4,
                                    density=0.15, seed=8)


def _cooc():
    rng = np.random.default_rng(6)
    dense = (rng.random((45, 45)) < 0.25) * rng.integers(1, 20, (45, 45))
    return sparse.csr_matrix(dense.astype(np.float64))


def _run(name, data, n_dev):
    np.random.seed(5)
    with use_mesh(MeshContext.create(jax.devices()[:n_dev])):
        if name == "glove":
            m = GloVe(num_components=6, batch_size=64)
            m.fit(_cooc(), num_epochs=3)
            return m.W, m.bias
        if name == "evaluator":
            rng = np.random.default_rng(1)
            ev = AoaEvaluator(data.test, data.train, k=[1, 5],
                              num_negatives=15)
            res = ev.evaluate(rng.normal(size=(77, 6)),
                              rng.normal(size=(51, 6)), seed=4)
            return np.asarray([res[k] for k in sorted(res)]),
        if name == "recommend":
            rng = np.random.default_rng(2)
            return recommend(rng.normal(size=(77, 6)),
                             rng.normal(size=(51, 6)), k=5,
                             exclude=data.train)
        m = {"bpr": lambda: BPR(num_components=6, learning_rate=0.02,
                                batch_size=128),
             "relmf": lambda: RelMF(num_components=6, batch_size=256),
             "wmf": lambda: WMF(num_components=6, chunk_size=16),
             "expomf": lambda: ExpoMF(num_components=6, chunk_size=16),
             }[name]()
        m.fit(data.train, num_epochs=3, verbose=False)
        return m.W, m.H


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", ["bpr", "relmf", "wmf", "expomf", "glove",
                                  "evaluator", "recommend"])
def test_matches_single_device(data, name, n_dev):
    ref = _run(name, data, 1)
    got = _run(name, data, n_dev)
    if name == "recommend":
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
        return
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
