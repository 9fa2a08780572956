"""Every float32 product of the ALS solves, the ExpoMF E-step, the
evaluator and ``recommend`` lowers with ``precision=HIGHEST``: without it
the GPU may run it in TF32 (checked from the lowered StableHLO, so it holds
whatever the backend)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cymf_tpu.parallel import MeshContext

C, P, K, N = 8, 4, 16, 40


def _dots(lowered_text):
    return [line for line in lowered_text.splitlines()
            if "stablehlo.dot_general" in line]


def _assert_all_highest(fn, *args):
    dots = _dots(fn.lower(*args).as_text())
    assert dots, "no product lowered"
    weak = [d for d in dots
            if not re.search(r"precision = \[HIGHEST, HIGHEST\]", d)]
    assert not weak, "\n".join(d.strip()[:200] for d in weak)


def _als_args():
    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, N, (C, P)), jnp.int32)
    valid = jnp.ones((C, P), bool)
    return Y, idx, valid


def _mesh(n=2):
    return MeshContext.create(jax.devices()[:n])


def site_gramian():
    from cymf_tpu.ops.als import gramian
    return jax.jit(gramian), (_als_args()[0],)


def site_wmf_correction():
    from cymf_tpu.ops.als import wmf_chunk_solve
    Y, idx, valid = _als_args()
    return (functools.partial(wmf_chunk_solve, solver="cholesky_xla"),
            (Y, jnp.eye(K), idx, valid, jnp.float32(10.0)))


def site_wmf_correction_blocked():
    from cymf_tpu.ops.als import wmf_chunk_solve
    Y, idx, valid = _als_args()
    return (functools.partial(wmf_chunk_solve, solver="cholesky_blocked8"),
            (Y, jnp.eye(K), idx, valid, jnp.float32(10.0)))


def site_woodbury():
    from cymf_tpu.ops.als import wmf_chunk_solve_woodbury
    Y, idx, valid = _als_args()
    return (functools.partial(wmf_chunk_solve_woodbury,
                              solver="cholesky_xla"),
            (Y, jnp.eye(K), idx, valid, jnp.float32(10.0)))


def site_blocked_cholesky():
    from cymf_tpu.ops.als import solve_spd_blocked
    A = jnp.broadcast_to(jnp.eye(32) * 2.0, (C, 32, 32))
    return (jax.jit(functools.partial(solve_spd_blocked, block=8)),
            (A, jnp.ones((C, 32))))


def site_expomf_chunk():
    from cymf_tpu.models.expomf import _expomf_chunk
    Y, idx, valid = _als_args()
    rows = jnp.arange(C, dtype=jnp.int32)
    return (functools.partial(_expomf_chunk, solver="cholesky_xla",
                              num_real_rows=C),
            (Y, Y, Y, jnp.full((N,), 99.0), rows, idx, valid,
             jnp.float32(1.0), jnp.eye(K) * 0.01, jnp.float32(0.4)))


def site_evaluator():
    from cymf_tpu.evaluation.evaluator import _evaluate_group
    from cymf_tpu.ops.hashset import build_pair_hashset
    Y, idx, valid = _als_args()
    hs = build_pair_hashset(np.arange(4), np.arange(4))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    return (functools.partial(_evaluate_group, num_negatives=5, ks=(5,),
                              metric_names=("DCG",), unbiased=False),
            (Y, Y, jnp.zeros((2, C), jnp.int32), idx[None].repeat(2, 0),
             valid[None].repeat(2, 0), hs, jnp.ones(N), keys))


def site_evaluator_sharded():
    from cymf_tpu.evaluation.evaluator import _sharded_group_eval
    fn, args = site_evaluator()
    return (_sharded_group_eval(_mesh(), 5, (5,), ("DCG",), False), args)


def site_recommend():
    from cymf_tpu.evaluation.recommend import _topk_chunk
    Y, idx, valid = _als_args()
    return (functools.partial(_topk_chunk, k=3), (Y[:C], Y, idx, valid))


def site_recommend_sharded():
    from cymf_tpu.evaluation.recommend import _topk_sharded
    Y, idx, valid = _als_args()
    return _topk_sharded(_mesh(), 3, N), (Y[:C], Y, idx, valid)


def site_wmf_sharded():
    from cymf_tpu.parallel.shard_step import sharded_wmf_chunk
    Y, idx, valid = _als_args()
    fn = sharded_wmf_chunk(_mesh(), 10.0, 0.01, K, "cholesky_xla",
                           wb_max_p=P)
    return fn, (Y, Y, jnp.arange(C, dtype=jnp.int32), idx, valid)


def site_expomf_sharded():
    from cymf_tpu.parallel.shard_step import sharded_expomf_chunk
    Y, idx, valid = _als_args()
    fn = sharded_expomf_chunk(_mesh(), 1.0, 0.01, 0.4, K, "cholesky_xla",
                              "col", N, N)
    return fn, (Y, Y, Y, jnp.full((N,), 99.0), Y,
                jnp.arange(C, dtype=jnp.int32), idx, valid)


SITES = [site_gramian, site_wmf_correction, site_wmf_correction_blocked,
         site_woodbury, site_blocked_cholesky, site_expomf_chunk,
         site_evaluator, site_evaluator_sharded, site_recommend,
         site_recommend_sharded, site_wmf_sharded, site_expomf_sharded]


@pytest.mark.parametrize("site", SITES, ids=lambda f: f.__name__[5:])
def test_products_lower_with_highest(site):
    fn, args = site()
    if not hasattr(fn, "lower"):
        fn = jax.jit(fn)
    _assert_all_highest(fn, *args)


def test_unpinned_product_is_caught():
    """The check itself: a DEFAULT-precision product fails it."""
    fn = jax.jit(lambda a: a.T @ a)
    with pytest.raises(AssertionError, match="dot_general"):
        _assert_all_highest(fn, jnp.ones((4, 3)))


@pytest.mark.gpu
def test_wmf_solve_accuracy_on_gpu(require_gpu):
    """On the card: a pinned WMF chunk solve keeps float32 accuracy
    against a float64 solve (TF32 would lose ~3 digits)."""
    from cymf_tpu.ops.als import gramian, wmf_chunk_solve
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(2000, 128)) * 0.1
    idx = rng.integers(0, 2000, (64, 32))
    A0 = np.asarray(gramian(jnp.asarray(Y, jnp.float32))) + 0.01 * np.eye(128)
    x = np.asarray(wmf_chunk_solve(
        jnp.asarray(Y, jnp.float32), jnp.asarray(A0, jnp.float32),
        jnp.asarray(idx, jnp.int32), jnp.ones((64, 32), bool),
        jnp.float32(10.0), solver="cholesky_xla"))
    G = Y.T @ Y + 0.01 * np.eye(128)
    for r in range(64):
        S = Y[idx[r]]
        ref = np.linalg.solve(G + 9.0 * S.T @ S, 10.0 * S.sum(0))
        assert np.linalg.norm(x[r] - ref) <= 1e-4 * np.linalg.norm(ref)
