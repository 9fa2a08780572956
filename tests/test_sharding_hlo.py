"""Compile-time proof of multi-chip compute partitioning.

Compiles the explicit shard_map BPR epoch on the 8-device CPU mesh and
asserts, from the compiled HLO:

* no collective ever moves a table-sized payload — all comm is O(batch);
* per-device FLOPs shrink with mesh size (the gradient work is actually
  partitioned, not replicated).

These tests fail if the partitioning ever regresses to XLA choosing a
replicated-compute or table-gathering strategy.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cymf_tpu.ops.hashset import build_pair_hashset
from cymf_tpu.optim import Adam
from cymf_tpu.parallel import MeshContext
from cymf_tpu.parallel.shard_step import sharded_bpr_epoch

U, I, K, B, S = 1024, 512, 16, 256, 2

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _compiled_text(n_devices):
    mesh = MeshContext.create(jax.devices()[:n_devices])
    opt = Adam(0.001)
    rng = np.random.default_rng(0)
    W = mesh.put_table(jnp.asarray(rng.normal(size=(U, K)), jnp.float32))
    H = mesh.put_table(jnp.asarray(rng.normal(size=(I, K)), jnp.float32))
    ow, oh = opt.init(W), opt.init(H)
    u = jax.device_put(jnp.asarray(rng.integers(0, U, (S, B)), jnp.int32),
                       mesh.batch2d())
    i = jax.device_put(jnp.asarray(rng.integers(0, I, (S, B)), jnp.int32),
                       mesh.batch2d())
    hs = jax.tree_util.tree_map(
        mesh.put_replicated, build_pair_hashset(
            np.arange(U, dtype=np.int64), np.zeros(U, np.int64)))
    fn = sharded_bpr_epoch(mesh, opt, 0.01, U, I)
    lowered = fn.lower(W, H, ow, oh, u, i, hs, jnp.asarray(S * B, jnp.int32),
                       jax.random.PRNGKey(0))
    compiled = lowered.compile()
    return compiled


@pytest.fixture(scope="module")
def compiled8():
    assert len(jax.devices()) >= 8
    return _compiled_text(8)


def test_no_table_sized_collectives(compiled8):
    """Every collective payload must be batch-sized (< table size)."""
    text = compiled8.as_text()
    table_elems = U * K  # smallest table-sized payload we must never move
    offenders = []
    for line in text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        for shape in re.findall(r"[a-z0-9]+\[([0-9,]+)\]", line):
            dims = [int(d) for d in shape.split(",") if d]
            elems = int(np.prod(dims)) if dims else 1
            if elems >= table_elems:
                offenders.append(line.strip()[:160])
    assert not offenders, "table-sized collectives found:\n" + \
        "\n".join(offenders)


def test_collectives_present(compiled8):
    """Sanity: the explicit exchange really compiled to collectives."""
    text = compiled8.as_text()
    assert any(c in text for c in ("all-gather", "all-to-all")), \
        "expected explicit row-exchange collectives in the HLO"
    assert "reduce-scatter" in text or "all-reduce" in text


def test_per_device_flops_shrink_with_mesh(compiled8):
    """The per-device compiled module must do ~1/n of the 1-device FLOPs
    for the partitioned stages (gradient math dominates at these shapes)."""
    c1 = _compiled_text(1)
    f1 = c1.cost_analysis()["flops"]
    f8 = compiled8.cost_analysis()["flops"]
    assert f8 < 0.55 * f1, (f1, f8)


# ---------------------------------------------------------------------------
# Sharded evaluator / recommender
# ---------------------------------------------------------------------------

EU, EI, EK, EC, EG, EP, ENEG = 4096, 512, 16, 1024, 2, 8, 100


def _eval_compiled(n_devices):
    from cymf_tpu.evaluation.evaluator import (_evaluate_group,
                                               _sharded_group_eval)
    from cymf_tpu.parallel.mesh import MeshContext
    import functools as ft

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.normal(size=(EU, EK)), jnp.float32)
    H = jnp.asarray(rng.normal(size=(EI, EK)), jnp.float32)
    uids = jnp.asarray(rng.integers(0, EU, (EG, EC)), jnp.int32)
    pos = jnp.asarray(rng.integers(0, EI, (EG, EC, EP)), jnp.int32)
    valid = jnp.asarray(rng.random((EG, EC, EP)) < 0.5)
    hs = jax.tree_util.tree_map(
        jnp.asarray, build_pair_hashset(np.arange(EU, dtype=np.int64),
                                        np.zeros(EU, np.int64)))
    props = jnp.full((EI,), 0.5, jnp.float32)
    keys = jax.vmap(ft.partial(jax.random.fold_in,
                               jax.random.PRNGKey(0)))(jnp.arange(EG))
    statics = dict(num_negatives=ENEG, ks=(5,), metric_names=("DCG",),
                   unbiased=False)
    if n_devices == 1:
        fn = jax.jit(ft.partial(_evaluate_group, **statics))
    else:
        fn = _sharded_group_eval(mesh, ENEG, (5,), ("DCG",), False)
    return fn.lower(W, H, uids, pos, valid, hs, props, keys).compile()


@pytest.fixture(scope="module")
def eval_compiled8():
    assert len(jax.devices()) >= 8
    return _eval_compiled(8)


def test_evaluator_flops_shrink_with_mesh(eval_compiled8):
    """Per-device evaluation FLOPs must shrink with the mesh: the scoring
    einsum, top-k and metric math are partitioned over users."""
    f1 = _eval_compiled(1).cost_analysis()["flops"]
    f8 = eval_compiled8.cost_analysis()["flops"]
    assert f8 < 0.3 * f1, (f1, f8)


def test_evaluator_only_metric_sized_collectives(eval_compiled8):
    """The only collective payload is the [n_metrics, n_ks] psum (plus
    scalar reductions) — never users- or table-sized."""
    text = eval_compiled8.as_text()
    offenders = []
    for line in text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        for shape in re.findall(r"[a-z0-9]+\[([0-9,]+)\]", line):
            dims = [int(d) for d in shape.split(",") if d]
            elems = int(np.prod(dims)) if dims else 1
            if elems > 64:  # [n_metrics, n_ks] sums only
                offenders.append(line.strip()[:160])
    assert not offenders, "oversized collectives:\n" + "\n".join(offenders)


RU, RI, RK, RTOPK = 512, 2048, 16, 10


def _rec_compiled(n_devices):
    from cymf_tpu.evaluation.recommend import _topk_chunk, _topk_sharded
    from cymf_tpu.parallel.mesh import MeshContext
    import functools as ft

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.normal(size=(RU, RK)), jnp.float32)
    H = jnp.asarray(rng.normal(size=(RI, RK)), jnp.float32)
    excl = jnp.asarray(rng.integers(0, RI, (RU, 4)), jnp.int32)
    ev = jnp.ones((RU, 4), bool)
    if n_devices == 1:
        fn = jax.jit(ft.partial(_topk_chunk, k=RTOPK))
    else:
        fn = _topk_sharded(mesh, RTOPK, RI)
    return fn.lower(W, H, excl, ev).compile()


@pytest.fixture(scope="module")
def rec_compiled8():
    assert len(jax.devices()) >= 8
    return _rec_compiled(8)


def test_recommend_flops_shrink_with_mesh(rec_compiled8):
    """The full-catalog scoring matmul partitions over the item axis."""
    f1 = _rec_compiled(1).cost_analysis()["flops"]
    f8 = rec_compiled8.cost_analysis()["flops"]
    assert f8 < 0.3 * f1, (f1, f8)


def test_recommend_only_topk_sized_collectives(rec_compiled8):
    """Merge comm is O(users x n x k) — never catalog-sized (RU x RI
    scores) nor table-sized (RI x K)."""
    text = rec_compiled8.as_text()
    cap = RU * 8 * RTOPK * 2  # gathered per-shard winners (values + ids)
    offenders = []
    for line in text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        for shape in re.findall(r"[a-z0-9]+\[([0-9,]+)\]", line):
            dims = [int(d) for d in shape.split(",") if d]
            elems = int(np.prod(dims)) if dims else 1
            if elems > cap:
                offenders.append(line.strip()[:160])
    assert not offenders, "oversized collectives:\n" + "\n".join(offenders)


# ---------------------------------------------------------------------------
# RelMF / GloVe explicit shard_map epochs
# ---------------------------------------------------------------------------

MU, MI, MK, MB, MSTEPS = 1024, 512, 16, 256, 2


def _relmf_compiled(n_devices):
    from cymf_tpu.models.relmf import (_relmf_epoch_jit,
                                       _sharded_relmf_epoch_jit)
    from cymf_tpu.parallel.mesh import MeshContext

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    W = mesh.put_table(jnp.asarray(rng.normal(size=(MU, MK)), jnp.float32))
    H = mesh.put_table(jnp.asarray(rng.normal(size=(MI, MK)), jnp.float32))
    hs = jax.tree_util.tree_map(
        mesh.put_replicated, build_pair_hashset(
            np.arange(MU, dtype=np.int64), np.zeros(MU, np.int64)))
    props = mesh.put_replicated(jnp.full((MI, 1), 0.5, jnp.float32))
    if n_devices == 1:
        opt, fn = _relmf_epoch_jit("adam", 0.001, 0.01, 0.1, MU, MI,
                                   MSTEPS, MB, "dense", True)
    else:
        opt, fn = _sharded_relmf_epoch_jit(mesh, "adam", 0.001, 0.01, 0.1,
                                           MU, MI, MSTEPS, MB, True)
    ow, oh = opt.init(W), opt.init(H)
    return fn.lower(W, H, ow, oh, hs, props, jax.random.PRNGKey(0),
                    jnp.asarray(0, jnp.int32)).compile()


def _glove_compiled(n_devices):
    from cymf_tpu.models.glove import (_glove_epoch_jit,
                                       _sharded_glove_epoch_jit)
    from cymf_tpu.parallel.mesh import MeshContext

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    width = MK + 2
    Wc = mesh.put_table(jnp.asarray(rng.normal(size=(MU, width)),
                                    jnp.float32))
    Wx = mesh.put_table(jnp.asarray(rng.normal(size=(MI, width)),
                                    jnp.float32))
    c = jax.device_put(jnp.asarray(rng.integers(0, MU, (MSTEPS, MB)),
                                   jnp.int32), mesh.batch2d())
    x = jax.device_put(jnp.asarray(rng.integers(0, MI, (MSTEPS, MB)),
                                   jnp.int32), mesh.batch2d())
    cnt = jax.device_put(jnp.asarray(
        rng.integers(1, 40, (MSTEPS, MB)).astype(np.float32)),
        mesh.batch2d())
    nv = jnp.asarray(MSTEPS * MB, jnp.int32)
    if n_devices == 1:
        opt, fn = _glove_epoch_jit(0.01, 10.0, 0.75, MK, MU, "dense",
                                   "fused")
        bias = jnp.zeros((1, 1), jnp.float32)
        ow, oh = opt.init(Wc), opt.init(Wx)
        return fn.lower(Wc, Wx, bias, bias, ow, oh, jnp.ones_like(bias),
                        jnp.ones_like(bias), c, x, cnt, nv).compile()
    opt, fn = _sharded_glove_epoch_jit(mesh, 0.01, 10.0, 0.75, MK, MU)
    ow, oh = opt.init(Wc), opt.init(Wx)
    return fn.lower(Wc, Wx, ow, oh, c, x, cnt, nv).compile()


def _assert_no_table_collectives(text, table_elems):
    offenders = []
    for line in text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        for shape in re.findall(r"[a-z0-9]+\[([0-9,]+)\]", line):
            dims = [int(d) for d in shape.split(",") if d]
            elems = int(np.prod(dims)) if dims else 1
            if elems >= table_elems:
                offenders.append(line.strip()[:160])
    assert not offenders, "table-sized collectives found:\n" + \
        "\n".join(offenders)


def test_relmf_sharded_no_table_collectives_and_flops_shrink():
    assert len(jax.devices()) >= 8
    c8 = _relmf_compiled(8)
    _assert_no_table_collectives(c8.as_text(), MU * MK)
    f1 = _relmf_compiled(1).cost_analysis()["flops"]
    f8 = c8.cost_analysis()["flops"]
    assert f8 < 0.55 * f1, (f1, f8)


def test_glove_sharded_no_table_collectives_and_flops_shrink():
    assert len(jax.devices()) >= 8
    c8 = _glove_compiled(8)
    _assert_no_table_collectives(c8.as_text(), MU * MK)
    f1 = _glove_compiled(1).cost_analysis()["flops"]
    f8 = c8.cost_analysis()["flops"]
    assert f8 < 0.55 * f1, (f1, f8)


# WMF proof shapes: tables much bigger than the chunk exchange, so a
# table-sized collective is distinguishable from the legitimate
# O(chunk-rows x pad x K) row exchange (= WC*WP_*WKC = 512k elements).
WU2, WI2 = 65536, 32768
WC, WP_, WKC = 512, 64, 16


def _wmf_compiled(n_devices):
    from cymf_tpu.ops.als import wmf_chunk_solve
    from cymf_tpu.parallel.mesh import MeshContext
    from cymf_tpu.parallel.shard_step import sharded_wmf_chunk
    import functools as ft

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    Y = mesh.put_table(jnp.asarray(rng.normal(size=(WI2, WKC)),
                                   jnp.float32))
    T = mesh.put_table(jnp.asarray(rng.normal(size=(WU2, WKC)),
                                   jnp.float32))
    rows = mesh.put_replicated(
        jnp.asarray(rng.permutation(WU2)[:WC], jnp.int32))
    idx = jnp.asarray(rng.integers(0, WI2, (WC, WP_)), jnp.int32)
    valid = jnp.asarray(rng.random((WC, WP_)) < 0.7)
    if n_devices == 1:
        def solve_and_scatter(Y, T, rows, idx, valid):
            A0 = (jnp.matmul(Y.T, Y, preferred_element_type=jnp.float32)
                  + 0.01 * jnp.eye(WKC, dtype=Y.dtype))
            x = wmf_chunk_solve(Y, A0, idx, valid,
                                jnp.asarray(10.0, Y.dtype),
                                solver="cholesky")
            return T.at[rows].set(x, mode="drop", unique_indices=True)
        fn = jax.jit(solve_and_scatter)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from cymf_tpu.parallel.mesh import ROW_AXIS
        sh2 = NamedSharding(mesh.mesh, P(ROW_AXIS, None))
        idx = jax.device_put(idx, sh2)
        valid = jax.device_put(valid, sh2)
        fn = sharded_wmf_chunk(mesh, 10.0, 0.01, WKC, "cholesky")
    return fn.lower(Y, T, rows, idx, valid).compile()


def test_wmf_sharded_no_table_collectives_and_flops_shrink():
    assert len(jax.devices()) >= 8
    c8 = _wmf_compiled(8)
    _assert_no_table_collectives(c8.as_text(), WI2 * WKC)
    f1 = _wmf_compiled(1).cost_analysis()["flops"]
    f8 = c8.cost_analysis()["flops"]
    assert f8 < 0.55 * f1, (f1, f8)


# ExpoMF proof shapes: other-side table (EI2 x EKC) much bigger than the
# chunk exchange (EC*EP_*EKC + EC*EKC^2 elements), so a table-sized
# collective is distinguishable from the legitimate O(chunk) comm.
EU2, EI2 = 65536, 32768
EC, EP_, EKC = 512, 64, 16


def _expomf_compiled(n_devices):
    from cymf_tpu.models.expomf import _expomf_chunk
    from cymf_tpu.parallel.shard_step import sharded_expomf_chunk

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    W0 = mesh.put_table(jnp.asarray(rng.normal(size=(EU2, EKC)) * 0.01,
                                    jnp.float32))
    H0 = mesh.put_table(jnp.asarray(rng.normal(size=(EI2, EKC)) * 0.01,
                                    jnp.float32))
    T = mesh.put_table(jnp.asarray(rng.normal(size=(EU2, EKC)),
                                   jnp.float32))
    mu_term = jnp.full((EI2,), 99.0, jnp.float32)
    rows = mesh.put_replicated(
        jnp.asarray(rng.permutation(EU2)[:EC], jnp.int32))
    idx = jnp.asarray(rng.integers(0, EI2, (EC, EP_)), jnp.int32)
    valid = jnp.asarray(rng.random((EC, EP_)) < 0.7)
    if n_devices == 1:
        def solve_and_scatter(W0, H0, mu_term, T, rows, idx, valid):
            x, cs = _expomf_chunk(
                W0, H0, H0, mu_term, rows, idx, valid,
                jnp.float32(1.0), 0.01 * jnp.eye(EKC, dtype=jnp.float32),
                jnp.float32(0.4), solver="cholesky", num_real_rows=EU2)
            return T.at[rows].set(x, mode="drop",
                                  unique_indices=True), cs
        fn = jax.jit(solve_and_scatter)
        return fn.lower(W0, H0, mu_term, T, rows, idx, valid).compile()
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cymf_tpu.parallel.mesh import ROW_AXIS
    sh2 = NamedSharding(mesh.mesh, P(ROW_AXIS, None))
    idx = jax.device_put(idx, sh2)
    valid = jax.device_put(valid, sh2)
    mu_term = jax.device_put(mu_term,
                             NamedSharding(mesh.mesh, P(ROW_AXIS)))
    fn = sharded_expomf_chunk(mesh, 1.0, 0.01, 0.4, EKC, "cholesky",
                              "col", EU2, EI2)
    return fn.lower(W0, H0, H0, mu_term, T, rows, idx, valid).compile()


def test_expomf_sharded_no_table_collectives_and_flops_shrink():
    assert len(jax.devices()) >= 8
    c8 = _expomf_compiled(8)
    _assert_no_table_collectives(c8.as_text(), EI2 * EKC)
    f1 = _expomf_compiled(1).cost_analysis()["flops"]
    f8 = c8.cost_analysis()["flops"]
    assert f8 < 0.55 * f1, (f1, f8)


def _glove_kfold_compiled(n_devices):
    from cymf_tpu.models.glove import (_glove_epoch_jit,
                                       _sharded_glove_kfold_epoch_jit)

    mesh = MeshContext.create(jax.devices()[:n_devices])
    rng = np.random.default_rng(0)
    Wc = mesh.put_table(jnp.asarray(rng.normal(size=(MU, MK)),
                                    jnp.float32))
    Wx = mesh.put_table(jnp.asarray(rng.normal(size=(MI, MK)),
                                    jnp.float32))
    bc = mesh.put_table(jnp.asarray(rng.normal(size=(MU, 1)), jnp.float32))
    bx = mesh.put_table(jnp.asarray(rng.normal(size=(MI, 1)), jnp.float32))
    c = jax.device_put(jnp.asarray(rng.integers(0, MU, (MSTEPS, MB)),
                                   jnp.int32), mesh.batch2d())
    x = jax.device_put(jnp.asarray(rng.integers(0, MI, (MSTEPS, MB)),
                                   jnp.int32), mesh.batch2d())
    cnt = jax.device_put(jnp.asarray(
        rng.integers(1, 40, (MSTEPS, MB)).astype(np.float32)),
        mesh.batch2d())
    nv = jnp.asarray(MSTEPS * MB, jnp.int32)
    if n_devices == 1:
        opt, fn = _glove_epoch_jit(0.01, 10.0, 0.75, MK, MU, "dense",
                                   "kfold")
        ow, oh = opt.init(Wc), opt.init(Wx)
        return fn.lower(Wc, Wx, bc, bx, ow, oh, jnp.ones_like(bc),
                        jnp.ones_like(bx), c, x, cnt, nv).compile()
    opt, fn = _sharded_glove_kfold_epoch_jit(mesh, 0.01, 10.0, 0.75, MK,
                                             MU)
    ow, oh = opt.init(Wc), opt.init(Wx)
    return fn.lower(Wc, Wx, bc, bx, ow, oh, jnp.ones_like(bc),
                    jnp.ones_like(bx), c, x, cnt, nv).compile()


def test_glove_kfold_sharded_no_table_collectives_and_flops_shrink():
    assert len(jax.devices()) >= 8
    c8 = _glove_kfold_compiled(8)
    _assert_no_table_collectives(c8.as_text(), MU * MK)
    f1 = _glove_kfold_compiled(1).cost_analysis()["flops"]
    f8 = c8.cost_analysis()["flops"]
    assert f8 < 0.55 * f1, (f1, f8)


@pytest.mark.slow
def test_bpr_sharded_compiles_at_ml20m_scale():
    """Compile (not run) the sharded BPR epoch at REAL ML-20M shapes
    (the small proof shapes bound partitioning, not
    collective sizing at scale).  Asserts compilation succeeds on the
    8-device mesh and no collective exceeds the design's O(B*K)
    row-exchange payload.  Note the scale fact this encodes: at ML-20M,
    B*K (131072*20 = 2.62M elems) is ~5x the ITEM table (26752*20) and
    ~0.95x the USER table — the gradient all-gathers ARE
    batch-payload-sized, so the threshold is the user table, the
    smallest bound that admits the legitimate exchange."""
    assert len(jax.devices()) >= 8
    from cymf_tpu.optim import Adam as _Adam
    from cymf_tpu.parallel.shard_step import sharded_bpr_epoch

    RU, RI, RK, RB, RS = 138496, 26752, 20, 131072, 1
    mesh = MeshContext.create(jax.devices()[:8])
    opt = _Adam(0.001)
    W = jax.ShapeDtypeStruct((RU, RK), jnp.float32,
                             sharding=mesh.table())
    H = jax.ShapeDtypeStruct((RI, RK), jnp.float32,
                             sharding=mesh.table())
    ow = {"m": W, "v": W}
    oh = {"m": H, "v": H}
    u = jax.ShapeDtypeStruct((RS, RB), jnp.int32, sharding=mesh.batch2d())
    i = jax.ShapeDtypeStruct((RS, RB), jnp.int32, sharding=mesh.batch2d())
    hs_proto = build_pair_hashset(np.arange(64, dtype=np.int64),
                                  np.zeros(64, np.int64))
    hs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype,
                                       sharding=mesh.replicated()),
        hs_proto)
    fn = sharded_bpr_epoch(mesh, opt, 0.01, RU, RI)
    compiled = fn.lower(
        W, H, ow, oh, u, i, hs,
        jax.ShapeDtypeStruct((), jnp.int32, sharding=mesh.replicated()),
        jax.ShapeDtypeStruct((2,), jnp.uint32,
                             sharding=mesh.replicated())).compile()
    _assert_no_table_collectives(compiled.as_text(), RU * RK)


def test_sharded_bpr_compiles_at_ml20m_shapes():
    """The partition proofs above compile tiny shapes.  This compiles the XLA shard_map epoch at the REAL ML-20M
    bench shapes (138k users, 26.7k items, B=131072) on the 8-device mesh
    and asserts every collective payload stays batch-sized — at this
    batch the biggest legal payload is B*K (row exchange), still below
    the table."""
    from cymf_tpu.ops.hashset import build_pair_hashset
    from cymf_tpu.parallel.shard_step import sharded_bpr_epoch

    MU, MI, MK, MB = 138496, 26744, 20, 131072
    mesh = MeshContext.create(jax.devices()[:8])
    opt = Adam(0.001)
    rng = np.random.default_rng(0)
    W = mesh.put_table(jnp.zeros((MU, MK), jnp.float32))
    H = mesh.put_table(jnp.zeros((MI + (-MI) % 8, MK), jnp.float32))
    ow, oh = opt.init(W), opt.init(H)
    u = jax.device_put(jnp.asarray(rng.integers(0, MU, (1, MB)), jnp.int32),
                       mesh.batch2d())
    i = jax.device_put(jnp.asarray(rng.integers(0, MI, (1, MB)), jnp.int32),
                       mesh.batch2d())
    hs = jax.tree_util.tree_map(
        mesh.put_replicated,
        build_pair_hashset(rng.integers(0, MU, 1000).astype(np.int64),
                           rng.integers(0, MI, 1000).astype(np.int64)))
    fn = sharded_bpr_epoch(mesh, opt, 0.01, MU, H.shape[0])
    compiled = fn.lower(W, H, ow, oh, u, i, hs,
                        jnp.asarray(MB, jnp.int32),
                        jax.random.PRNGKey(0)).compile()
    text = compiled.as_text()
    offenders = []
    for line in text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        for shape in re.findall(r"[a-z0-9]+\[([0-9,]+)\]", line):
            dims = [int(d) for d in shape.split(",") if d]
            elems = int(np.prod(dims)) if dims else 1
            if elems > MB * MK:  # row exchange is the biggest legal payload
                offenders.append(line.strip()[:160])
    assert not offenders, \
        "beyond-batch-sized collectives at ML-20M shapes:\n" + \
        "\n".join(offenders)
