"""Times the plain-JAX stages on the GPU, one jitted function per stage.

    python scripts/stage_times.py [--out chiprun_out/stage_times.jsonl]

Two groups, each line a JSON object naming the card:

* ``stage``: the XLA stages of each training step at the shapes the
  benchmark uses (BPR at ML-20M, d=20 and d=256; RelMF at ML-20M; GloVe
  at 50k vocab; a BPR epoch at ml-100k) — the numbers a hand-written
  kernel for any of them has to beat;
* ``pin``: each float32 product pinned to ``precision=HIGHEST``, timed at
  HIGHEST and at DEFAULT (which lets the GPU use TF32), at the shapes of
  `chip_smoke.py`'s phases.

Each time is the median of ``--reps`` calls after a warm-up call, each
ended by ``block_until_ready``.  Needs the GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

HIGHEST = "highest"


def median_ms(fn, *args, reps=10):
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def bpr_stages(K, B, U=138493, I=26744, nnz=20_000_263, reps=10):
    """One BPR step of `models/bpr.py::_bpr_epoch`, and its parts."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.dataset.synthetic import bench_interactions
    from cymf_tpu.models.bpr import _bpr_epoch
    from cymf_tpu.ops.hashset import build_pair_hashset, hashset_contains
    from cymf_tpu.optim import Adam

    users, items = bench_interactions(U, I, nnz, seed=0)
    u = np.sort(users[:B]).astype(np.int32)
    i = items[:B].astype(np.int32)
    hs = jax.tree_util.tree_map(jnp.asarray,
                                build_pair_hashset(users, items))
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.uniform(-0.1, 0.1, (U, K)) / K, jnp.float32)
    H = jnp.asarray(rng.uniform(-0.1, 0.1, (I, K)) / K, jnp.float32)
    opt = Adam(0.001)
    ow, oh = opt.init(W), opt.init(H)
    ud, idd = jnp.asarray(u), jnp.asarray(i)
    key = jax.random.PRNGKey(0)
    j = jax.random.randint(key, (B,), 0, I, jnp.int32)
    out = {}

    step = jax.jit(functools.partial(
        _bpr_epoch, optimizer=opt, weight_decay=0.01, num_users=U,
        num_items=I, update_mode="dense", u_presorted=True))
    out["step"] = median_ms(step, W, H, ow, oh, ud[None], idd[None], hs,
                            jnp.int32(B), key, reps=reps)
    out["negative_draw"] = median_ms(jax.jit(
        lambda k: jax.random.randint(k, (B,), 0, I, jnp.int32)), key,
        reps=reps)
    out["hash_probe"] = median_ms(jax.jit(hashset_contains), hs, ud, j,
                                  reps=reps)

    @jax.jit
    def gather_score(W, H, u, i, j):
        wu, hi, hj = W[u], H[i], H[j]
        x = jnp.sum(wu * (hi - hj), axis=1, keepdims=True)
        sig = jax.nn.sigmoid(-x)
        g_wu = -(sig * (hi - hj) - 0.01 * wu)
        g_hi = -(sig * wu - 0.01 * hi)
        g_hj = -(-sig * wu - 0.01 * hj)
        loss = -jax.nn.log_sigmoid(x[:, 0])
        return g_wu, g_hi, g_hj, jnp.sum(loss)

    out["gather_score"] = median_ms(gather_score, W, H, ud, idd, j,
                                    reps=reps)
    g_wu, g_hi, g_hj, _ = gather_score(W, H, ud, idd, j)
    out["scatter_add_W"] = median_ms(jax.jit(
        lambda W, u, g: jnp.zeros_like(W).at[u].add(
            g, indices_are_sorted=True)), W, ud, g_wu, reps=reps)
    rows = jnp.concatenate([idd, j])
    grads = jnp.concatenate([g_hi, g_hj])
    out["scatter_add_H"] = median_ms(jax.jit(
        lambda H, r, g: jnp.zeros_like(H).at[r].add(g)), H, rows, grads,
        reps=reps)
    out["adam_dense_update_W+H"] = median_ms(jax.jit(
        lambda W, H, ow, oh, u, g1, r, g2: (
            opt.update_dense(W, ow, [(u, g1)], rows_sorted=True),
            opt.update_dense(H, oh, [(r, g2)]))),
        W, H, ow, oh, ud, g_wu, rows, grads, reps=reps)
    return out


def relmf_step_ms(B=131072, U=138493, I=26744, K=20, nnz=20_000_263,
                  reps=10):
    import jax
    import jax.numpy as jnp

    from cymf_tpu.dataset.synthetic import bench_interactions
    from cymf_tpu.models.relmf import _relmf_epoch_jit
    from cymf_tpu.ops.hashset import build_pair_hashset

    users, items = bench_interactions(U, I, nnz, seed=0)
    hs = jax.tree_util.tree_map(jnp.asarray,
                                build_pair_hashset(users, items))
    col = np.bincount(items, minlength=I) / U
    props = jnp.asarray((np.maximum(col / col.max(), 1e-5) ** 0.5)[:, None],
                        jnp.float32)
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.uniform(-0.1, 0.1, (U, K)) / K, jnp.float32)
    H = jnp.asarray(rng.uniform(-0.1, 0.1, (I, K)) / K, jnp.float32)
    steps = 64
    opt, fn = _relmf_epoch_jit("adam", 0.001, 0.01, 0.1, U, I, steps, B,
                               "dense", True)
    st = [W, H, opt.init(W), opt.init(H)]
    key = jax.random.PRNGKey(0)

    def run():
        st[:4] = fn(*st, hs, props, key, jnp.int32(0))[:4]
        return st[0]
    return median_ms(run, reps=reps) / steps


def glove_step_ms(V=50_000, nnz=3_000_000, K=50, B=131072, reps=10):
    import jax.numpy as jnp

    from cymf_tpu.models.glove import _glove_epoch_jit, augment_tables

    rng = np.random.default_rng(0)
    c = np.sort(rng.integers(0, V, B)).astype(np.int32)[None]
    x = rng.integers(0, V, B).astype(np.int32)[None]
    n = rng.integers(1, 50, B).astype(np.float32)[None]
    Zc, Zx = augment_tables(rng.normal(size=(V, K)) * 0.1,
                            rng.normal(size=V), rng.normal(size=(V, K)) * 0.1,
                            rng.normal(size=V))
    opt, fn = _glove_epoch_jit(0.01, 10.0, 0.75, K, V, "dense", "fused")
    Wc, Wx = jnp.asarray(Zc, jnp.float32), jnp.asarray(Zx, jnp.float32)
    one = jnp.ones((1, 1), jnp.float32)
    st = [Wc, Wx, 0 * one, 0 * one, opt.init(Wc), opt.init(Wx), one,
          one + 0]
    args = (jnp.asarray(c), jnp.asarray(x), jnp.asarray(n), jnp.int32(B))

    def run():
        st[:] = fn(*st, *args)[:8]
        return st[0]
    return median_ms(run, reps=reps)


def bpr_ml100k_epoch_ms(reps=10):
    """A whole BPR epoch through the XLA engine at ml-100k shapes
    (943 x 1682, ~55k interactions, d=20, batch 1024)."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.models.bpr import _bpr_epoch_jit
    from cymf_tpu.ops.hashset import build_pair_hashset

    U, I, N, K, B = 943, 1682, 55_296, 20, 1024
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    u2, i2 = u.reshape(-1, B), i.reshape(-1, B)
    order = np.argsort(u2, axis=1, kind="stable")
    u2 = np.take_along_axis(u2, order, 1)
    i2 = np.take_along_axis(i2, order, 1)
    hs = jax.tree_util.tree_map(jnp.asarray, build_pair_hashset(u, i))
    opt, fn = _bpr_epoch_jit("adam", 0.01, 0.01, U, I, "dense")
    W = jnp.asarray(rng.uniform(-0.1, 0.1, (U, K)) / K, jnp.float32)
    H = jnp.asarray(rng.uniform(-0.1, 0.1, (I, K)) / K, jnp.float32)
    st = [W, H, opt.init(W), opt.init(H)]
    args = (jnp.asarray(u2), jnp.asarray(i2), hs, jnp.int32(N),
            jax.random.PRNGKey(0))

    def run():
        st[:] = fn(*st, *args)[:4]
        return st[0]
    return median_ms(run, reps=reps)


def pin_costs(reps=10):
    """HIGHEST vs DEFAULT for each pinned product at its phase shapes."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.ops.als import woodbury_core

    key = jax.random.PRNGKey(0)

    def rnd(*shape, scale=1.0):
        nonlocal key
        key, sub = jax.random.split(key)
        return scale * jax.random.normal(sub, shape, jnp.float32)

    def pair(name, make_fn, *args):
        for prec in (HIGHEST, "default"):
            yield {"site": name, "precision": prec,
                   "ms": median_ms(jax.jit(make_fn(prec)), *args,
                                   reps=reps)}

    Yi, Yu = rnd(26744, 256, scale=0.1), rnd(138493, 256, scale=0.1)
    sub = rnd(2048, 128, 256, scale=0.1)
    sub_w = rnd(2048, 64, 256, scale=0.1)
    A0i = jnp.eye(256) * 0.5
    valid = jnp.ones((2048, 64), bool)
    E, Y20 = jax.nn.sigmoid(rnd(512, 3706)), rnd(3706, 20, scale=0.01)
    Ws = rnd(512, 20, scale=0.01)
    h, w = rnd(4096, 132, 20), rnd(4096, 20)
    Wr, Hr = rnd(4096, 20), rnd(26744, 20)

    def mm(spec):
        return lambda p: (lambda a, b: jnp.einsum(spec, a, b, precision=p))

    sites = [
        ("wmf_gramian_items", mm("ik,il->kl"), Yi, Yi),
        ("wmf_gramian_users", mm("ik,il->kl"), Yu, Yu),
        ("wmf_rank_P_correction_P128", mm("cpk,cpl->ckl"), sub, sub),
        ("expomf_estep_scores", mm("ck,ik->ci"), Ws, Y20),
        ("expomf_weighted_gramian",
         lambda p: (lambda E, Y: jnp.einsum("ci,ik,il->ckl", E, Y, Y,
                                            precision=p)), E, Y20),
        ("evaluator_scores", mm("clk,ck->cl"), h, w),
        ("recommend_scores", mm("ck,ik->ci"), Wr, Hr),
    ]
    for name, make_fn, *args in sites:
        yield from pair(name, make_fn, *args)
    # the Woodbury einsums (pinned inside woodbury_core) against the same
    # algebra at DEFAULT precision
    yield {"site": "woodbury_core_P64", "precision": HIGHEST,
           "ms": median_ms(jax.jit(lambda s, a, v: woodbury_core(
               s, a, v, 10.0, "cholesky_xla")), sub_w, A0i, valid,
               reps=reps)}

    def woodbury_default(s, a, v):
        b = 10.0 * jnp.sum(s, axis=1)
        T = jnp.einsum("kl,cpl->cpk", a, s)
        M = jnp.eye(64) / 9.0 + jnp.einsum("cpk,cqk->cpq", s, T)
        a0ib = jnp.einsum("kl,cl->ck", a, b)
        z = jnp.linalg.solve(M, jnp.einsum("cpk,ck->cp", s, a0ib)[..., None])
        return a0ib - jnp.einsum("cpk,cp->ck", T, z[..., 0])
    yield {"site": "woodbury_core_P64", "precision": "default",
           "ms": median_ms(jax.jit(woodbury_default), sub_w, A0i, valid,
                           reps=reps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "stage_times.jsonl"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    from cymf_tpu.utils.runtime import (card_info, enable_compile_cache,
                                        require_gpu)
    enable_compile_cache(REPO)
    devices = require_gpu()
    card = card_info()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def emit(rec):
        rec = dict(rec, card=card, device_kind=devices[0].device_kind)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    for K in (20, 256):
        for name, ms in bpr_stages(K, 131072, reps=args.reps).items():
            emit({"group": "stage", "what": f"bpr_ml20m_d{K}_B131072",
                  "stage": name, "ms": ms})
    emit({"group": "stage", "what": "relmf_ml20m_d20_B131072",
          "stage": "step", "ms": relmf_step_ms(reps=args.reps)})
    emit({"group": "stage", "what": "glove_50k_d50_B131072",
          "stage": "step", "ms": glove_step_ms(reps=args.reps)})
    emit({"group": "stage", "what": "bpr_ml100k_d20_B1024",
          "stage": "epoch", "ms": bpr_ml100k_epoch_ms(reps=args.reps)})
    for rec in pin_costs(reps=args.reps):
        emit(dict(rec, group="pin"))


if __name__ == "__main__":
    main()
