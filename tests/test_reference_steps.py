"""One step of each XLA engine against a float64 numpy step of the same
equations (`model.pyx` gradients, `optimizer.pyx` updates): BPR over
optimizer x update mode x K, RelMF over optimizer x labels x update mode,
GloVe over bias mode x K x update mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse

from cymf_tpu.optim import make_optimizer

LR, WD = 0.05, 0.01
B1, B2, EPS = 0.9, 0.999, 1e-8


def np_update(name, T, state, g):
    """float64 dense update of ``T`` by the summed gradient ``g``
    (`optimizer.pyx`; untouched rows are left alone)."""
    if name == "sgd":
        return T - LR * g, state
    if name == "adagrad":
        acc = state["accum"] + g * g
        return T - LR * g / np.sqrt(acc), {"accum": acc}
    touched = np.any(g != 0, axis=1, keepdims=True)
    m = np.where(touched, B1 * state["m"] + (1 - B1) * g, state["m"])
    v = np.where(touched, B2 * state["v"] + (1 - B2) * g * g, state["v"])
    d = np.where(touched,
                 -LR * (m / (1 - B1)) / (np.sqrt(v / (1 - B2)) + EPS), 0.0)
    return T + d, {"m": m, "v": v}


def np_state(name, T):
    if name == "adam":
        return {"m": np.zeros_like(T), "v": np.zeros_like(T)}
    if name == "adagrad":
        return {"accum": np.ones_like(T)}
    return {}


def assert_step_close(got, want, opt_name="sgd"):
    # Adam's step -lr*g/(|g|+eps) is ill-conditioned where |g| nears eps:
    # there float32 rounding moves it by up to ~1e-3 of a step
    atol = 1e-3 * LR if opt_name == "adam" else 2e-6
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=2e-4, atol=atol)


@pytest.mark.parametrize("K", [20, 128, 256])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("opt_name", ["sgd", "adagrad", "adam"])
def test_bpr_step_matches_float64(opt_name, mode, K):
    from cymf_tpu.models.bpr import _bpr_epoch
    from cymf_tpu.ops.hashset import build_pair_hashset

    U, I, B = 60, 40, 256
    rng = np.random.default_rng(K)
    X = sparse.random(U, I, density=0.2, random_state=K, format="csr")
    pu, pi = X.nonzero()
    u = np.sort(rng.integers(0, U, B)).astype(np.int32)
    i = rng.integers(0, I, B).astype(np.int32)
    u[-3:] = 2**31 - 1  # padding samples
    W = rng.uniform(-0.5, 0.5, (U, K)) / np.sqrt(K)
    H = rng.uniform(-0.5, 0.5, (I, K)) / np.sqrt(K)
    key = jax.random.PRNGKey(3)
    opt = make_optimizer(opt_name, LR)
    out = jax.jit(functools.partial(
        _bpr_epoch, optimizer=opt, weight_decay=WD, num_users=U,
        num_items=I, update_mode=mode, u_presorted=True))(
        jnp.asarray(W, jnp.float32), jnp.asarray(H, jnp.float32),
        opt.init(jnp.zeros((U, K))), opt.init(jnp.zeros((I, K))),
        u[None], i[None], build_pair_hashset(pu, pi), jnp.int32(B - 3), key)

    # the engine's negatives: step 0 folds index 0 into the epoch key
    j = np.asarray(jax.random.randint(jax.random.fold_in(key, 0), (B,), 0,
                                      I, dtype=jnp.int32))
    W32 = W.astype(np.float32).astype(np.float64)
    H32 = H.astype(np.float32).astype(np.float64)
    pos = set(zip(pu.tolist(), pi.tolist()))
    live = (u < U) & np.array([(a, b) not in pos for a, b in zip(u, j)])
    uc = np.where(u < U, u, 0)
    mf = live[:, None].astype(np.float64)
    wu, hi, hj = W32[uc], H32[i], H32[j]
    x = np.sum(wu * (hi - hj), axis=1, keepdims=True)
    sig = 1.0 / (1.0 + np.exp(x))
    gW, gH = np.zeros_like(W32), np.zeros_like(H32)
    np.add.at(gW, uc, -(sig * (hi - hj) - WD * wu) * mf)
    np.add.at(gH, i, -(sig * wu - WD * hi) * mf)
    np.add.at(gH, j, -(-sig * wu - WD * hj) * mf)
    Wn, _ = np_update(opt_name, W32, np_state(opt_name, W32), gW)
    Hn, _ = np_update(opt_name, H32, np_state(opt_name, H32), gH)
    loss = np.sum((np.log1p(np.exp(-x[:, 0]))
                   + WD * (np.sum(wu ** 2, 1) + np.sum(hi ** 2, 1)
                           + np.sum(hj ** 2, 1))) * live) / (B - 3)
    assert_step_close(out[0], Wn, opt_name)
    assert_step_close(out[1], Hn, opt_name)
    np.testing.assert_allclose(float(out[4]), loss, rtol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("labels", ["binary", "weighted"])
@pytest.mark.parametrize("opt_name", ["sgd", "adagrad", "adam"])
def test_relmf_step_matches_float64(opt_name, labels, mode):
    from cymf_tpu.models.relmf import _relmf_epoch
    from cymf_tpu.ops.hashset import build_pair_hashset

    U, I, K, B, M = 50, 30, 8, 512, 0.1
    rng = np.random.default_rng(7)
    X = sparse.random(U, I, density=0.3, random_state=7, format="csr")
    X.data = (np.ones_like(X.data) if labels == "binary"
              else rng.integers(1, 6, X.nnz).astype(np.float64))
    X.sort_indices()
    props = rng.uniform(0.01, 1.0, I)
    W = rng.uniform(-0.5, 0.5, (U, K))
    H = rng.uniform(-0.5, 0.5, (I, K))
    if labels == "binary":
        coo = X.tocoo()
        label_src = build_pair_hashset(coo.row, coo.col)
    else:
        label_src = (jnp.asarray(X.indptr, jnp.int32),
                     jnp.asarray(X.indices, jnp.int32),
                     jnp.asarray(X.data, jnp.float32))
    key = jax.random.PRNGKey(5)
    opt = make_optimizer(opt_name, LR)
    out = jax.jit(functools.partial(
        _relmf_epoch, optimizer=opt, weight_decay=WD, clip_value=M,
        num_users=U, num_items=I, num_steps=1, batch_size=B,
        update_mode=mode, binary_labels=labels == "binary"))(
        jnp.asarray(W, jnp.float32), jnp.asarray(H, jnp.float32),
        opt.init(jnp.zeros((U, K))), opt.init(jnp.zeros((I, K))),
        label_src, jnp.asarray(props[:, None], jnp.float32), key,
        jnp.int32(0))

    ku, ki = jax.random.split(jax.random.fold_in(key, 0))
    u = np.asarray(jax.random.randint(ku, (B,), 0, U, dtype=jnp.int32))
    i = np.asarray(jax.random.randint(ki, (B,), 0, I, dtype=jnp.int32))
    r = np.asarray(X[u, i]).ravel()
    p32 = props.astype(np.float32).astype(np.float64)
    w = (r / np.maximum(p32[i], M))[:, None]
    W32 = W.astype(np.float32).astype(np.float64)
    H32 = H.astype(np.float32).astype(np.float64)
    wu, hi = W32[u], H32[i]
    s = np.sum(wu * hi, axis=1, keepdims=True)
    gW, gH = np.zeros_like(W32), np.zeros_like(H32)
    np.add.at(gW, u, -(w * (1 - s) * hi + (1 - w) * (0 - s) * hi) + WD * wu)
    np.add.at(gH, i, -(w * (1 - s) * wu + (1 - w) * (0 - s) * wu) + WD * hi)
    Wn, _ = np_update(opt_name, W32, np_state(opt_name, W32), gW)
    Hn, _ = np_update(opt_name, H32, np_state(opt_name, H32), gH)
    assert_step_close(out[0], Wn, opt_name)
    assert_step_close(out[1], Hn, opt_name)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("K", [8, 50, 128])
@pytest.mark.parametrize("bias_mode", ["fused", "kfold"])
def test_glove_step_matches_float64(bias_mode, K, mode):
    from cymf_tpu.models.glove import _glove_epoch, augment_tables
    from cymf_tpu.optim import AdaGrad

    V, B, x_max, alpha = 70, 256, 10.0, 0.75
    rng = np.random.default_rng(K)
    c = np.sort(rng.integers(0, V, B)).astype(np.int32)
    x = rng.integers(0, V, B).astype(np.int32)
    cnt = rng.integers(1, 30, B).astype(np.float64)
    c[-2:] = 2**31 - 1  # padding triples
    Wc = rng.uniform(-0.5, 0.5, (V, K)) / K
    Wx = rng.uniform(-0.5, 0.5, (V, K)) / K
    bc, bx = rng.uniform(-0.5, 0.5, V) / K, rng.uniform(-0.5, 0.5, V) / K
    opt = AdaGrad(LR)
    if bias_mode == "fused":
        Tc, Tx = augment_tables(Wc, bc, Wx, bx)
        bcol = bxcol = np.zeros((1, 1))
    else:
        Tc, Tx, bcol, bxcol = Wc, Wx, bc[:, None], bx[:, None]
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    out = jax.jit(functools.partial(
        _glove_epoch, optimizer=opt, x_max=x_max, alpha=alpha,
        learning_rate=LR, num_components=K, num_central=V,
        update_mode=mode, bias_mode=bias_mode))(
        f32(Tc), f32(Tx), f32(bcol), f32(bxcol), opt.init(f32(Tc)),
        opt.init(f32(Tx)), jnp.ones_like(f32(bcol)),
        jnp.ones_like(f32(bxcol)), c[None], x[None], f32(cnt)[None],
        jnp.int32(B - 2))

    r32 = [np.asarray(a, np.float32).astype(np.float64)
           for a in (Tc, Tx, bcol, bxcol)]
    Tc, Tx, bcol, bxcol = r32
    live = (c < V).astype(np.float64)
    cc = np.where(c < V, c, 0)
    wc, hx = Tc[cc], Tx[x]
    f = np.minimum((cnt / x_max) ** alpha, 1.0)
    diff = np.sum(wc * hx, axis=1) - np.log(cnt)
    if bias_mode == "kfold":
        diff = diff + bcol[cc, 0] + bxcol[x, 0]
    fd = (f * diff * live)[:, None]
    g_c, g_x = fd * hx, fd * wc
    if bias_mode == "fused":
        g_c[:, K + 1] = 0.0  # constant columns stay constant
        g_x[:, K] = 0.0
    gC, gX = np.zeros_like(Tc), np.zeros_like(Tx)
    np.add.at(gC, cc, g_c)
    np.add.at(gX, x, g_x)
    Cn, _ = np_update("adagrad", Tc, {"accum": np.ones_like(Tc)}, gC)
    Xn, _ = np_update("adagrad", Tx, {"accum": np.ones_like(Tx)}, gX)
    assert_step_close(out[0], Cn)
    assert_step_close(out[1], Xn)
    if bias_mode == "kfold":
        # K AdaGrad steps with the summed per-row gradient (model.pyx:195)
        for rows, col, got in ((cc, bcol, out[2]), (x, bxcol, out[3])):
            g = np.zeros(V)
            np.add.at(g, rows, fd[:, 0])
            t = np.arange(1, K + 1)
            delta = -LR * g * np.sum(1 / np.sqrt(1.0 + t[None] * g[:, None]
                                                 ** 2), axis=1)
            assert_step_close(got[:, 0], col[:, 0] + delta)
