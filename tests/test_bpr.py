"""BPR trainer tests: convergence on synthetic low-rank data (runs on the
8-device virtual CPU mesh, exercising the sharded path end-to-end)."""

import numpy as np
import pytest

from cymf_tpu import BPR, AoaEvaluator
from cymf_tpu.dataset import SyntheticImplicitDataset


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=120, num_item=80, rank=4,
                                    density=0.15, seed=0)


def _dcg(model, data):
    ev = AoaEvaluator(data.test, data.train, metrics=["DCG"], k=5)
    return ev.evaluate(model.W, model.H)["DCG@5"]


def test_bpr_learns_ranking(data):
    model = BPR(num_components=8, learning_rate=0.02, optimizer="adam",
                weight_decay=0.001, batch_size=256)
    model.fit(data.train, num_epochs=2, verbose=False)
    before = _dcg(model, data)
    model.fit(data.train, num_epochs=60, verbose=False)
    after = _dcg(model, data)
    assert after > before + 0.05, (before, after)
    assert after > 0.2


def test_bpr_loss_decreases(data):
    model = BPR(num_components=8, learning_rate=0.02, batch_size=256)
    model.fit(data.train, num_epochs=1, verbose=False)
    first = model.last_loss
    model.fit(data.train, num_epochs=30, verbose=False)
    last = model.last_loss
    assert last < first


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_bpr_all_optimizers_run(data, opt):
    lr = 0.05 if opt != "sgd" else 0.5
    model = BPR(num_components=4, learning_rate=lr, optimizer=opt,
                batch_size=128)
    model.fit(data.train, num_epochs=3, verbose=False)
    assert np.all(np.isfinite(model.W))
    assert np.all(np.isfinite(model.H))
    assert model.W.shape == (data.num_user, 4)
    assert model.H.shape == (data.num_item, 4)


def test_bpr_warm_start_preserved(data):
    model = BPR(num_components=4, batch_size=128)
    W0 = np.full((data.num_user, 4), 0.123)
    model.W = W0.copy()
    model.fit(data.train, num_epochs=0, verbose=False)
    np.testing.assert_allclose(model.W, W0)


def test_bpr_early_stopping_restores_best(data):
    ev = AoaEvaluator(data.valid, data.train, metrics=["DCG"], k=5)
    model = BPR(num_components=8, learning_rate=0.02, batch_size=256)
    model.fit(data.train, num_epochs=60, valid_evaluator=ev,
              early_stopping=True, verbose=False)
    restored = ev.evaluate(model.W, model.H)["DCG@5"]
    # restored weights must reproduce the best validation DCG seen
    assert restored == pytest.approx(model.valid_dcg, abs=1e-6)


def test_bpr_invalid_optimizer():
    with pytest.raises(Exception):
        BPR(optimizer="nope")


def test_bpr_invalid_input():
    with pytest.raises(ValueError):
        BPR().fit(None)
    with pytest.raises(ValueError):
        BPR().fit("not a matrix")
