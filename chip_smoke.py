"""On-card smoke test: every ``fit()`` path, the evaluator and ``recommend``
on the GPU, each checked against a plain reference.

    python chip_smoke.py            # one card: the five default phases
    python chip_smoke.py --four     # four cards vs a one-device mesh only

One process drives every card it uses.  Data comes from
``cymf_tpu.dataset.synthetic`` with ``--seed``, so nothing is downloaded.
Each phase prints one line with its set-up time (the first call, which
compiles), its wall time after warm-up, the process's
``peak_bytes_in_use`` and its comparison, beside the card's name and power
limit.  Any failed phase makes the script exit non-zero; the last line,
printed only when every phase passed on a GPU, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import numpy as np

DEFAULT_PHASES = ("bpr_ml20m", "wmf_ml20m_d256", "chol_forms",
                  "relmf_expomf_glove", "eval_recommend")
FOUR_PHASES = ("four_bpr", "four_wmf", "four_relmf_expomf_glove",
               "four_eval_recommend")

# (users, items, interactions): ML-20M; ml-1m; GloVe (vocab, triples)
REAL = dict(ml20m=(138493, 26744, 20_000_263), ml1m=(6040, 3706),
            glove=(50_000, 3_000_000), batch=131072, chol=(2048, 256),
            rec_users=2048, rows=256)

ABS_TOL = 1e-5          # elementwise agreement of one update
FLIP_FRACTION = 1e-5    # most Adam outliers allowed (fraction of elements)
# Adam's sqrt(v_hat) at or below which an element counts as ill-conditioned:
# there a change of 1e-7 in a summed gradient (the rounding of a float32
# sum of a few hundred terms of 1e-3..1e-2) moves the step
# -lr * m_hat / (sqrt(v_hat) + eps) by up to 2 * lr * 1e-7 / ILL_GRAD,
# i.e. by ABS_TOL at lr = 1e-3
ILL_GRAD = 2e-5
EVAL_TOL = 1e-4         # metric agreement
TIE_RTOL = 1e-5         # top-k near-tie (float64 scores)
SOLVE_FACTOR, SOLVE_SLACK = 2.0, 1e-6


# ---------------------------------------------------------------------------
# rules (CPU-tested in tests/test_chip_smoke.py)

def check_devices(devices, need: int):
    """The first ``need`` devices; refuses any platform but the GPU."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{platform!r}); nothing was run")
    if len(devices) < need:
        raise SystemExit(f"chip_smoke: need {need} devices, JAX found "
                         f"{len(devices)}")
    return list(devices[:need])


def result_line(devices) -> str:
    """The script's last line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def select_phases(four: bool):
    return FOUR_PHASES if four else DEFAULT_PHASES


def compare_updates(got, ref, flip_cap: float, tol: float = ABS_TOL,
                    ill=None):
    """Agreement of two runs of the same updates, e.g. on two devices.

    Elements agree when ``|got - ref| <= tol``.  The exception is Adam's
    ill-conditioned step ``-lr * m_hat / (sqrt(v_hat) + eps)``: where every
    gradient an element has received is within rounding of zero, summing
    it in another order (GPU atomics, another device count) moves the
    step anywhere in ``[-lr, lr]``.  Such outliers must be fewer than
    ``FLIP_FRACTION`` of all elements, at most one per row (they are rare
    and independent; a fault spans rows or whole rows), each within
    ``flip_cap`` (``2 * lr`` per step that can flip; 0 allows none: SGD,
    AdaGrad, ALS) and, when ``ill`` (the reference's ill-conditioned
    elements, see :func:`ill_conditioned`) is given, among those.  Returns
    ``(ok, max_abs_diff, outlier_fraction)``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    out = diff > tol
    frac = float(out.sum()) / max(diff.size, 1)
    ok = (frac < FLIP_FRACTION
          and bool((diff[out] <= flip_cap).all())
          and int(out.reshape(len(out), -1).sum(axis=1).max(initial=0)) <= 1
          and (ill is None or not bool((out & ~ill).any())))
    return ok, float(diff.max(initial=0.0)), frac


def ill_conditioned(v_steps, beta2: float = 0.999):
    """Elements whose Adam second moment, after any of the steps
    ``v_steps`` (``v`` after each step of the reference run), puts
    ``sqrt(v_hat)`` at or below ``ILL_GRAD`` (``v_hat = v / (1 - beta2)``,
    the constant bias correction of ``optim.Adam``): every gradient they
    had received was within rounding of zero."""
    ill = np.zeros(np.shape(v_steps[0]), bool)
    for v in v_steps:
        v = np.asarray(v, np.float64)
        ill |= (v > 0) & (np.sqrt(v / (1.0 - beta2)) <= ILL_GRAD)
    return ill


def scaled_close(got, ref, tol: float = ABS_TOL):
    """``|got - ref| <= tol * max(1, |ref|)`` elementwise (ALS solutions,
    whose scale follows the data); returns ``(ok, max_scaled_diff)``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scaled = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    return bool((scaled <= tol).all()), float(scaled.max(initial=0.0))


def topk_matches(ids, scores64, k: int, rtol: float = TIE_RTOL):
    """Top-k ids against float64 scores (``-inf`` where excluded).

    Position ``j`` may hold another id than the float64 top-k only where
    the two ids' float64 scores differ by less than ``rtol`` relative (a
    near-tie, e.g. between the 10th and 11th item).  Returns
    ``(ok, rows_with_a_tie_swap)``."""
    ref = np.argsort(-scores64, axis=1, kind="stable")[:, :k]
    rows = np.arange(len(ids))[:, None]
    s_got = scores64[rows, ids]
    s_ref = scores64[rows, ref]
    same = ids == ref
    near = np.abs(s_got - s_ref) <= rtol * np.maximum(np.abs(s_ref), 1e-30)
    ok = bool(np.isfinite(s_got).all() and (same | near).all())
    return ok, int((~same).any(axis=1).sum())


def rel_err(x, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-300))


def require(cond, message: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(message)


def solve_rule(err: float, err_ref: float) -> bool:
    """A solve passes when its relative error is at most twice the
    reference float32 run's, plus 1e-6."""
    return err <= SOLVE_FACTOR * err_ref + SOLVE_SLACK


# ---------------------------------------------------------------------------
# harness

class Ctx:
    def __init__(self, seed, devices, card):
        import jax
        self.seed, self.devices, self.card = seed, devices, card
        self.cache = {}
        try:
            self.cpu = jax.devices("cpu")[0]
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: no CPU device for the reference "
                             f"runs: {e}")

    def peak(self):
        """``peak_bytes_in_use`` of each device in use (process-wide
        peaks: they only grow from phase to phase)."""
        peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", -1))
                 for d in self.devices]
        return peaks[0] if len(peaks) == 1 else peaks


def timed(fn):
    """(result, seconds) of ``fn()`` ended by ``block_until_ready``."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def warm_and_time(fn):
    """(result, setup_s, wall_s): the first call compiles (set-up), the
    second is timed."""
    _, setup = timed(fn)
    out, wall = timed(fn)
    return out, setup, wall


def on_device(device, fn, *args, **static):
    """``fn(*args)`` jitted on ``device`` (inputs placed there), as numpy."""
    import functools

    import jax
    args = jax.device_put(args, device)
    out = jax.jit(functools.partial(fn, **static))(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def ml20m_csr(ctx):
    if "ml20m" not in ctx.cache:
        from scipy import sparse

        from cymf_tpu.dataset.synthetic import bench_interactions
        U, I, nnz = REAL["ml20m"]
        users, items = bench_interactions(U, I, nnz, seed=ctx.seed)
        X = sparse.csr_matrix(
            (np.ones(nnz, np.float64), (users, items)), shape=(U, I))
        X.data[:] = 1.0
        ctx.cache["ml20m"] = X
    return ctx.cache["ml20m"]


def ml1m_csr(ctx):
    if "ml1m" not in ctx.cache:
        from cymf_tpu.dataset import SyntheticImplicitDataset
        U, I = REAL["ml1m"]
        d = SyntheticImplicitDataset(num_user=U, num_item=I, rank=8,
                                     density=0.04, seed=ctx.seed)
        ctx.cache["ml1m"] = d.train.tocsr()
    return ctx.cache["ml1m"]


def glove_csr(ctx):
    if "glove" not in ctx.cache:
        from scipy import sparse
        V, nnz = REAL["glove"]
        rng = np.random.default_rng(ctx.seed)
        ctx.cache["glove"] = sparse.csr_matrix(
            (rng.integers(1, 50, nnz).astype(np.float64),
             (rng.integers(0, V, nnz), rng.integers(0, V, nnz))),
            shape=(V, V))
    return ctx.cache["glove"]


def fit_timed(make, X, **kw):
    """(model, setup_s, wall_s): a warm-up fit (compiles) then a timed
    fit of a fresh model; ``make()`` must build identical models."""
    m = make()
    t0 = time.perf_counter()
    m.fit(X, verbose=False, **kw)
    setup = time.perf_counter() - t0
    m = make()
    t0 = time.perf_counter()
    m.fit(X, verbose=False, **kw)  # returns host tables: work has ended
    return m, setup, time.perf_counter() - t0


def seeded_tables(U, I, K, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.1, 0.1, (U, K)) / K,
            rng.uniform(-0.1, 0.1, (I, K)) / K)


# ---------------------------------------------------------------------------
# the BPR step reference: 4 steps of the XLA engine, GPU vs CPU device

def bpr_steps(ctx, X, K, steps, opt_name, lr=0.001, wd=0.01):
    """``steps`` steps of the XLA engine on the card and on the CPU device
    from the same tables, batches and key: ``(ok, max|diff|, outliers)``."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.models.bpr import _bpr_epoch
    from cymf_tpu.ops.hashset import build_pair_hashset
    from cymf_tpu.optim import make_optimizer

    U, I = X.shape
    B = REAL["batch"]
    coo = X.tocoo()
    rng = np.random.default_rng(ctx.seed)
    pick = rng.permutation(coo.nnz)[:steps * B]
    u2 = coo.row[pick].astype(np.int32).reshape(steps, B)
    i2 = coo.col[pick].astype(np.int32).reshape(steps, B)
    order = np.argsort(u2, axis=1, kind="stable")
    u2 = np.take_along_axis(u2, order, axis=1)
    i2 = np.take_along_axis(i2, order, axis=1)
    W0, H0 = (t.astype(np.float32) for t in seeded_tables(U, I, K, ctx.seed))
    opt = make_optimizer(opt_name, lr)
    hs = build_pair_hashset(coo.row, coo.col)
    static = dict(optimizer=opt, weight_decay=wd, num_users=U,
                  num_items=I, update_mode="dense", u_presorted=True)

    def args(t):  # the first t steps (step keys fold in the step index)
        return (W0, H0, opt.init(jnp.asarray(W0)), opt.init(jnp.asarray(H0)),
                u2[:t], i2[:t], hs, np.int32(t * B),
                jax.random.PRNGKey(ctx.seed))
    g = on_device(ctx.devices[0], _bpr_epoch, *args(steps), **static)
    c = on_device(ctx.cpu, _bpr_epoch, *args(steps), **static)
    if opt_name != "adam":
        okw, dw, fw = compare_updates(g[0], c[0], 0.0)
        okh, dh, fh = compare_updates(g[1], c[1], 0.0)
        return okw and okh, max(dw, dh), max(fw, fh)
    # the reference's second moments after each step
    prefix = [on_device(ctx.cpu, _bpr_epoch, *args(t), **static)
              for t in range(1, steps)] + [c]
    okw, dw, fw = compare_updates(
        g[0], c[0], 2 * lr * steps,
        ill=ill_conditioned([p[2]["v"] for p in prefix]))
    okh, dh, fh = compare_updates(
        g[1], c[1], 2 * lr * steps,
        ill=ill_conditioned([p[3]["v"] for p in prefix]))
    return okw and okh, max(dw, dh), max(fw, fh)


def phase_bpr_ml20m(ctx):
    from cymf_tpu import BPR
    X = ml20m_csr(ctx)
    B = REAL["batch"]
    out = {"setup_s": {}, "wall_s": {}}
    for K, epochs in ((20, 2), (256, 1)):
        m, setup, wall = fit_timed(
            lambda: BPR(num_components=K, batch_size=B, optimizer="adam"),
            X, num_epochs=epochs)
        require(np.isfinite(m.W).all() and np.isfinite(m.H).all()
                and np.isfinite(m.last_loss), f"BPR d={K}: non-finite")
        out["setup_s"][f"d{K}x{epochs}ep"] = setup
        out["wall_s"][f"d{K}x{epochs}ep"] = wall
        if K == 20:
            ctx.cache["bpr_factors"] = (m.W, m.H)
            out["interactions_per_s_d20"] = X.nnz * epochs / wall
    parts, ok = [], True
    for opt_name in ("sgd", "adam"):
        good, diff, frac = bpr_steps(ctx, X, 20, 4, opt_name)
        ok &= good
        parts.append(f"{opt_name}: max|diff| {diff:.3e}, beyond 1e-5 "
                     f"{frac:.2e} ({'pass' if good else 'FAIL'})")
    out["compare"] = "4 steps card vs CPU device: " + "; ".join(parts)
    return ok, out


# ---------------------------------------------------------------------------
# WMF: sampled rows against a float64 solve from the same Y

def wmf_sample_rows(ctx, X, K, wb_max_p, chunk_size=2048):
    """Sampled user rows from Woodbury- and Cholesky-routed chunks, with
    each row's chunk pad ``P`` (which fixes its route)."""
    from cymf_tpu.ops.als import build_chunks
    pad_of = {}
    for ch in build_chunks(X, chunk_size, X.shape[0], num_components=K):
        P = ch.idx_pad.shape[1]
        for r in ch.rows:
            pad_of[int(r)] = P
    rows = np.asarray(sorted(pad_of))
    pads = np.asarray([pad_of[r] for r in rows])
    rng = np.random.default_rng(ctx.seed)
    n = REAL["rows"]
    out = {}
    for route, sel in (("woodbury", pads <= wb_max_p),
                       ("cholesky", pads > wb_max_p)):
        cand = rows[sel]
        if len(cand):
            pick = np.sort(rng.choice(cand, min(n, len(cand)),
                                      replace=False))
            out[route] = (pick, np.asarray([pad_of[r] for r in pick]))
    return out


def wmf_f64(X, Y, rows, weight, wd):
    Y64 = np.asarray(Y, np.float64)
    G = Y64.T @ Y64 + wd * np.eye(Y64.shape[1])
    out = np.empty((len(rows), Y64.shape[1]))
    for n, r in enumerate(rows):
        S = Y64[X.indices[X.indptr[r]:X.indptr[r + 1]]]
        out[n] = np.linalg.solve(G + (weight - 1.0) * S.T @ S,
                                 weight * S.sum(axis=0))
    return out


def _padded(X, rows, P):
    idx = np.zeros((len(rows), P), np.int32)
    valid = np.zeros((len(rows), P), bool)
    for n, r in enumerate(rows):
        cols = X.indices[X.indptr[r]:X.indptr[r + 1]]
        idx[n, :len(cols)] = cols
        valid[n, :len(cols)] = True
    return idx, valid


def wmf_rows_f32(device, X, Y, rows, pads, weight, wd, solver, wb_max_p):
    """The library's chunk solves for ``rows`` on ``device``, each row in
    a chunk with its fit-time pad (hence its fit-time route)."""
    import jax
    import jax.numpy as jnp

    from cymf_tpu.ops.als import (gramian, wmf_chunk_solve,
                                  wmf_chunk_solve_woodbury)
    Yd = jax.device_put(np.asarray(Y, np.float32), device)
    A0 = gramian(Yd) + wd * jax.device_put(
        np.eye(Y.shape[1], dtype=np.float32), device)
    A0i = jnp.linalg.inv(A0)
    w = jax.device_put(np.float32(weight), device)
    out = np.empty((len(rows), Y.shape[1]))
    for P in np.unique(pads):
        sel = pads == P
        idx, valid = jax.device_put(_padded(X, rows[sel], int(P)), device)
        if P <= wb_max_p:
            x = wmf_chunk_solve_woodbury(Yd, A0i, idx, valid, w,
                                         solver=solver)
        else:
            x = wmf_chunk_solve(Yd, A0, idx, valid, w, solver=solver)
        out[sel] = np.asarray(x)
    return out


def wmf_rows_tf32(X, Y, rows, pads, weight, wd):
    """The same normal equations in plain JAX with TF32 products: the
    teeth of the solve rule."""
    import jax
    import jax.numpy as jnp
    with jax.default_matmul_precision("tensorfloat32"):
        Yd = jnp.asarray(Y, jnp.float32)
        A0 = Yd.T @ Yd + wd * jnp.eye(Y.shape[1])
        out = np.empty((len(rows), Y.shape[1]))
        for P in np.unique(pads):
            sel = pads == P
            idx, valid = _padded(X, rows[sel], int(P))
            sub = Yd[idx] * jnp.asarray(valid)[..., None]
            A = A0[None] + (weight - 1.0) * jnp.einsum("cpk,cpl->ckl",
                                                       sub, sub)
            b = weight * jnp.sum(sub, axis=1)
            out[sel] = np.asarray(jnp.linalg.solve(A, b[..., None])[..., 0])
    return out


def phase_wmf_ml20m_d256(ctx):
    from cymf_tpu import WMF
    from cymf_tpu.ops.als import resolve_chol_solver
    X = ml20m_csr(ctx)
    U, I = X.shape
    K = 256
    W0, H0 = seeded_tables(U, I, K, ctx.seed)

    def make():
        m = WMF(num_components=K)
        m.W, m.H = W0.copy(), H0.copy()
        return m

    m, setup, wall = fit_timed(make, X, num_epochs=1)
    require(np.isfinite(m.W).all() and np.isfinite(m.H).all(),
            "WMF: non-finite tables")
    solver = resolve_chol_solver("cholesky", K)
    samples = wmf_sample_rows(ctx, X, K, m.woodbury_max_p_)
    ok, parts, teeth = True, [], []
    for route, (rows, pads) in samples.items():
        ref = wmf_f64(X, H0, rows, m.weight, m.weight_decay)
        e_gpu = rel_err(m.W[rows], ref)
        e_cpu = rel_err(wmf_rows_f32(ctx.cpu, X, H0, rows, pads, m.weight,
                                     m.weight_decay, solver,
                                     m.woodbury_max_p_), ref)
        good = solve_rule(e_gpu, e_cpu)
        ok &= good
        e_tf32 = rel_err(wmf_rows_tf32(X, H0, rows, pads, m.weight,
                                       m.weight_decay), ref)
        teeth.append(not solve_rule(e_tf32, e_cpu))
        parts.append(
            f"{route} {len(rows)} rows: rel err card {e_gpu:.3e} vs CPU f32 "
            f"{e_cpu:.3e} ({'pass' if good else 'FAIL'}); TF32 "
            f"{e_tf32:.3e} ("
            f"{'fails the rule' if teeth[-1] else 'PASSES the rule'})")
    ok &= any(teeth)
    return ok, {"setup_s": setup, "wall_s": wall, "solver": solver,
                "woodbury_max_p": m.woodbury_max_p_,
                "interactions_per_s": X.nnz / wall,
                "compare": "; ".join(parts)}


# ---------------------------------------------------------------------------

def phase_chol_forms(ctx):
    import jax
    import jax.numpy as jnp

    from cymf_tpu.ops.als import (HIGHEST, solve_lu, solve_spd_blocked,
                                  solve_spd_xla)
    C, K = REAL["chol"]
    key = jax.random.PRNGKey(ctx.seed)
    M = jax.random.normal(key, (C, K, K), jnp.float32)
    A = (jnp.einsum("cij,ckj->cik", M, M, precision=HIGHEST) / K
         + jnp.eye(K, dtype=jnp.float32))
    b = jax.random.normal(jax.random.fold_in(key, 1), (C, K), jnp.float32)
    n_ref = min(C, 256)
    A64 = np.asarray(A[:n_ref], np.float64)
    ref = np.linalg.solve(A64, np.asarray(b[:n_ref], np.float64)[..., None])
    ref = ref[..., 0]
    forms = {"cholesky_xla": jax.jit(solve_spd_xla),
             "cholesky_blocked64": jax.jit(
                 lambda A, b: solve_spd_blocked(A, b, block=64)),
             "lu": jax.jit(solve_lu)}
    setup, wall, errs, ok = {}, {}, {}, True
    for name, fn in forms.items():
        x, setup[name], wall[name] = warm_and_time(lambda: fn(A, b))
        errs[name] = rel_err(np.asarray(x[:n_ref]), ref)
        ok &= errs[name] <= 1e-4
    fastest = min(("cholesky_xla", "cholesky_blocked64"), key=wall.get)
    return ok, {"setup_s": setup, "wall_s": wall,
                "compare": f"rel err vs float64 numpy on {n_ref} systems "
                           + json.dumps(errs) + f"; faster Cholesky form "
                           f"at ({C}, {K}, {K}): {fastest}"}


# ---------------------------------------------------------------------------

def relmf_step(ctx, X, K=20, lr=0.001, wd=0.01, clip=0.1):
    import jax
    import jax.numpy as jnp

    from cymf_tpu.models.relmf import _relmf_epoch
    from cymf_tpu.ops.hashset import build_pair_hashset
    from cymf_tpu.optim import Adam
    U, I = X.shape
    coo = X.tocoo()
    col_mean = np.asarray(X.mean(axis=0)).ravel()
    props = (np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5)[:, None]
    W0, H0 = (t.astype(np.float32) for t in seeded_tables(U, I, K, ctx.seed))
    opt = Adam(lr)
    args = (W0, H0, opt.init(jnp.asarray(W0)), opt.init(jnp.asarray(H0)),
            build_pair_hashset(coo.row, coo.col), props.astype(np.float32),
            jax.random.PRNGKey(ctx.seed), np.int32(0))
    static = dict(optimizer=opt, weight_decay=wd, clip_value=clip,
                  num_users=U, num_items=I, num_steps=1,
                  batch_size=REAL["batch"], update_mode="dense",
                  binary_labels=True)
    g = on_device(ctx.devices[0], _relmf_epoch, *args, **static)
    c = on_device(ctx.cpu, _relmf_epoch, *args, **static)
    okw, dw, fw = compare_updates(g[0], c[0], 2 * lr,
                                  ill=ill_conditioned([c[2]["v"]]))
    okh, dh, fh = compare_updates(g[1], c[1], 2 * lr,
                                  ill=ill_conditioned([c[3]["v"]]))
    return okw and okh, max(dw, dh), max(fw, fh)


def expomf_step(ctx, X, K=20, lam_y=1.0, wd=0.01):
    import math

    from cymf_tpu.models.expomf import _expomf_chunk
    from cymf_tpu.ops.als import build_chunks
    U, I = X.shape
    rng = np.random.default_rng(ctx.seed)
    W0 = (rng.standard_normal((U, K)) * 0.01).astype(np.float32)
    H0 = (rng.standard_normal((I, K)) * 0.01).astype(np.float32)
    ch = build_chunks(X, 512, U, num_components=K)[-1]
    args = (W0, H0, H0, np.full(I, 99.0, np.float32), ch.rows, ch.idx_pad,
            ch.valid, np.float32(lam_y),
            (wd / lam_y) * np.eye(K, dtype=np.float32),
            np.float32(math.sqrt(lam_y / (2.0 * math.pi))))
    static = dict(solver="cholesky_xla", num_real_rows=U)
    g = on_device(ctx.devices[0], _expomf_chunk.__wrapped__, *args,
                  **static)
    c = on_device(ctx.cpu, _expomf_chunk.__wrapped__, *args, **static)
    ok1, d1 = scaled_close(g[0], c[0])
    ok2, d2 = scaled_close(g[1], c[1])
    return ok1 and ok2, max(d1, d2)


def glove_step(ctx, X, K=50, lr=0.01):
    import jax.numpy as jnp

    from cymf_tpu.models.glove import _glove_epoch, augment_tables
    from cymf_tpu.optim import AdaGrad
    V = X.shape[0]
    B = REAL["batch"]
    coo = X.tocoo()
    c = coo.row[:B].astype(np.int32)
    order = np.argsort(c, kind="stable")
    rng = np.random.default_rng(ctx.seed)
    Zc, Zx = augment_tables(
        rng.uniform(-0.5, 0.5, (V, K)) / K, rng.uniform(-0.5, 0.5, V) / K,
        rng.uniform(-0.5, 0.5, (V, K)) / K, rng.uniform(-0.5, 0.5, V) / K)
    Zc, Zx = Zc.astype(np.float32), Zx.astype(np.float32)
    opt = AdaGrad(lr)
    one = np.ones((1, 1), np.float32)
    args = (Zc, Zx, 0 * one, 0 * one, opt.init(jnp.asarray(Zc)),
            opt.init(jnp.asarray(Zx)), one, one, c[order][None],
            coo.col[:B].astype(np.int32)[order][None],
            coo.data[:B].astype(np.float32)[order][None], np.int32(B))
    static = dict(optimizer=opt, x_max=10.0, alpha=0.75, learning_rate=lr,
                  num_components=K, num_central=V, update_mode="dense",
                  bias_mode="fused")
    g = on_device(ctx.devices[0], _glove_epoch, *args, **static)
    cc = on_device(ctx.cpu, _glove_epoch, *args, **static)
    okc, dc, _ = compare_updates(g[0], cc[0], 0.0)
    okx, dx, _ = compare_updates(g[1], cc[1], 0.0)
    return okc and okx, max(dc, dx)


def phase_relmf_expomf_glove(ctx):
    from cymf_tpu import ExpoMF, GloVe, RelMF
    X = ml1m_csr(ctx)
    G = glove_csr(ctx)
    B = REAL["batch"]
    setup, wall, parts, ok = {}, {}, [], True

    m, setup["relmf"], wall["relmf"] = fit_timed(
        lambda: RelMF(num_components=20, batch_size=B), X, num_epochs=1)
    require(np.isfinite(m.W).all() and np.isfinite(m.last_loss),
            "RelMF: non-finite")
    good, d, f = relmf_step(ctx, X)
    ok &= good
    parts.append(f"relmf step max|diff| {d:.3e} beyond 1e-5 {f:.2e}")

    m, setup["expomf"], wall["expomf"] = fit_timed(
        lambda: ExpoMF(num_components=20), X, num_epochs=1)
    require(np.isfinite(m.W).all() and np.isfinite(m.mu).all(),
            "ExpoMF: non-finite")
    good, d = expomf_step(ctx, X)
    ok &= good
    parts.append(f"expomf chunk max scaled diff {d:.3e}")

    def make_glove():
        np.random.seed(ctx.seed)
        return GloVe(num_components=50, batch_size=B)

    np.random.seed(ctx.seed)
    m, setup["glove"], wall["glove"] = fit_timed(make_glove, G,
                                                 num_epochs=1)
    require(np.isfinite(m.W).all() and np.isfinite(m.last_loss),
            "GloVe: non-finite")
    good, d = glove_step(ctx, G)
    ok &= good
    parts.append(f"glove step max|diff| {d:.3e}")
    return ok, {"setup_s": setup, "wall_s": wall,
                "compare": "one step/chunk card vs CPU device: "
                           + "; ".join(parts)}


# ---------------------------------------------------------------------------

def eval_split(ctx):
    from scipy import sparse

    from cymf_tpu.dataset.synthetic import split_indices
    X = ml20m_csr(ctx).tocoo()
    tr, te = split_indices(np.arange(X.nnz))

    def part(sel):
        return sparse.csr_matrix((X.data[sel], (X.row[sel], X.col[sel])),
                                 shape=X.shape)
    return part(tr), part(te)


def bpr_factors(ctx):
    if "bpr_factors" not in ctx.cache:
        from cymf_tpu import BPR
        m = BPR(num_components=20, batch_size=REAL["batch"])
        m.fit(ml20m_csr(ctx), num_epochs=1, verbose=False)
        ctx.cache["bpr_factors"] = (m.W, m.H)
    return ctx.cache["bpr_factors"]


def rec_scores64(W, H, exclude):
    s = np.asarray(W, np.float64) @ np.asarray(H, np.float64).T
    ex = exclude.tocoo()
    s[ex.row, ex.col] = -np.inf
    return s


def phase_eval_recommend(ctx):
    import jax

    from cymf_tpu import AoaEvaluator, MeshContext, recommend, use_mesh
    W, H = bpr_factors(ctx)
    train, test = eval_split(ctx)
    ev = AoaEvaluator(test, train, metrics=["DCG", "Recall", "MAP"], k=5)
    res, setup_e, wall_e = warm_and_time(lambda: ev.evaluate(W, H))
    with jax.default_device(ctx.cpu), \
            use_mesh(MeshContext.create([ctx.cpu])):
        ref = AoaEvaluator(test, train, metrics=["DCG", "Recall", "MAP"],
                           k=5).evaluate(W, H)
    diff = max(abs(res[k] - ref[k]) for k in ref)
    ok_e = diff <= EVAL_TOL and all(np.isfinite(v) for v in res.values())

    n = REAL["rec_users"]
    (s, ids), setup_r, wall_r = warm_and_time(
        lambda: recommend(W[:n], H, k=10, exclude=train[:n]))
    ok_r, swaps = topk_matches(ids, rec_scores64(W[:n], H, train[:n]), 10)
    return ok_e and ok_r, {
        "setup_s": {"evaluate": setup_e, "recommend": setup_r},
        "wall_s": {"evaluate": wall_e, "recommend": wall_r},
        "compare": f"metrics vs CPU device max|diff| {diff:.3e} "
                   f"{json.dumps({k: round(v, 6) for k, v in res.items()})};"
                   f" top-10 of {n} users vs float64: {swaps} rows with a "
                   f"near-tie swap ({'pass' if ok_r else 'FAIL'})"}


# ---------------------------------------------------------------------------
# --four: the same fits on a 4-device mesh vs a 1-device mesh

def spy_device_sets(model, record):
    """Record, as ``fit`` ends, how many devices hold each state leaf."""
    import jax
    orig = model._finalize_fit

    def finalize(*a, **k):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                model._state)[0]:
            record[jax.tree_util.keystr(path)] = len(leaf.sharding.device_set)
        return orig(*a, **k)
    model._finalize_fit = finalize


def spy_factory(module, name, record, tables=("W", "H")):
    """Wrap ``module.name`` (a factory of jitted functions) so that every
    call of the functions it returns records how many devices hold its
    leading ``tables`` arguments.  Returns a function that restores the
    original."""
    orig = getattr(module, name)

    def factory(*a, **k):
        fn = orig(*a, **k)

        def call(*args):
            for t, arr in zip(tables, args):
                record[f"{name}:{t}"] = len(arr.sharding.device_set)
            return fn(*args)
        return call
    setattr(module, name, factory)
    return lambda: setattr(module, name, orig)


def four_fit(ctx, make, X, prepare=None, **kw):
    """(model on 4 devices, model on 1 device, times): on each mesh a
    first fit compiles (set-up) and a second, timed, is compared."""
    from cymf_tpu import MeshContext, use_mesh
    sets, out, models = {}, {}, {}
    for n in (4, 1):
        with use_mesh(MeshContext.create(ctx.devices[:n])):
            for label in ("setup", "wall"):
                if prepare:
                    prepare()
                m = make()
                if n == 4 and label == "wall":
                    spy_device_sets(m, sets)
                t0 = time.perf_counter()
                m.fit(X, verbose=False, **kw)  # returns host tables
                out[f"{label}_s_{n}dev"] = time.perf_counter() - t0
        models[n] = m
    bad = {k: v for k, v in sets.items() if v != 4}
    require(sets and not bad, f"state not spread over 4 devices: {bad}")
    out["leaves_on_4"] = len(sets)
    return models[4], models[1], out


def phase_four_bpr(ctx):
    from cymf_tpu import BPR
    X = ml20m_csr(ctx)
    B = REAL["batch"]
    m4, m1, out = four_fit(
        ctx, lambda: BPR(num_components=20, batch_size=B), X, num_epochs=1)
    # one ill-conditioned first-touch step per outlier: within 2 * lr
    okw, dw, fw = compare_updates(m4.W, m1.W, 2 * 0.001)
    okh, dh, fh = compare_updates(m4.H, m1.H, 2 * 0.001)
    out["compare"] = (f"1 epoch 4 vs 1 device: max|diff| {max(dw, dh):.3e},"
                      f" beyond 1e-5 {max(fw, fh):.2e}")
    ctx.cache["bpr_factors"] = (m4.W, m4.H)
    return okw and okh, out


def phase_four_wmf(ctx):
    from cymf_tpu import WMF
    X = ml20m_csr(ctx)
    U, I = X.shape
    K = 256
    W0, H0 = seeded_tables(U, I, K, ctx.seed)

    def make():
        m = WMF(num_components=K)
        m.W, m.H = W0.copy(), H0.copy()
        return m

    m4, m1, out = four_fit(ctx, make, X, num_epochs=1)
    parts, ok = [], True
    for route, (rows, _) in wmf_sample_rows(ctx, X, K,
                                            m1.woodbury_max_p_).items():
        ref = wmf_f64(X, H0, rows, m1.weight, m1.weight_decay)
        e4, e1 = rel_err(m4.W[rows], ref), rel_err(m1.W[rows], ref)
        good = solve_rule(e4, e1)
        ok &= good
        parts.append(f"{route} {len(rows)} rows: rel err 4 devices "
                     f"{e4:.3e} vs 1 device {e1:.3e} "
                     f"({'pass' if good else 'FAIL'})")
    good, d = scaled_close(m4.H, m1.H, 1e-3)
    parts.append(f"H max scaled diff {d:.3e}")
    out["compare"] = "; ".join(parts)
    return ok and good, out


def phase_four_relmf_expomf_glove(ctx):
    from cymf_tpu import ExpoMF, GloVe, RelMF
    X = ml1m_csr(ctx)
    G = glove_csr(ctx)
    B = REAL["batch"]
    out, parts, ok = {}, [], True

    r4, r1, out["relmf"] = four_fit(
        ctx, lambda: RelMF(num_components=20, batch_size=B), X,
        num_epochs=1)
    okw, dw, fw = compare_updates(r4.W, r1.W, 2 * 0.001)
    okh, dh, fh = compare_updates(r4.H, r1.H, 2 * 0.001)
    ok &= okw and okh
    parts.append(f"relmf max|diff| {max(dw, dh):.3e} beyond 1e-5 "
                 f"{max(fw, fh):.2e}")

    e4, e1, out["expomf"] = four_fit(
        ctx, lambda: ExpoMF(num_components=20), X, num_epochs=1)
    checks = [scaled_close(a, b, 1e-4) for a, b in
              ((e4.W, e1.W), (e4.H, e1.H), (e4.mu, e1.mu))]
    ok &= all(g for g, _ in checks)
    parts.append(f"expomf max scaled diff {max(d for _, d in checks):.3e}")

    g4, g1, out["glove"] = four_fit(
        ctx, lambda: GloVe(num_components=50, batch_size=B), G,
        prepare=lambda: np.random.seed(ctx.seed), num_epochs=1)
    good, d, _ = compare_updates(g4.W, g1.W, 0.0)
    ok &= good
    parts.append(f"glove max|diff| {d:.3e}")
    out["compare"] = "1 epoch 4 vs 1 device: " + "; ".join(parts)
    return ok, out


def phase_four_eval_recommend(ctx):
    import importlib

    from cymf_tpu import AoaEvaluator, MeshContext, recommend, use_mesh
    ev_mod = importlib.import_module("cymf_tpu.evaluation.evaluator")
    rec_mod = importlib.import_module("cymf_tpu.evaluation.recommend")
    W, H = bpr_factors(ctx)
    train, test = eval_split(ctx)
    n = REAL["rec_users"]
    sets = {}
    undo = [spy_factory(ev_mod, "_sharded_group_eval", sets),
            spy_factory(rec_mod, "_topk_sharded", sets)]
    try:
        with use_mesh(MeshContext.create(ctx.devices[:4])):
            ev = AoaEvaluator(test, train, k=5)
            r4, setup_e, wall_e = warm_and_time(lambda: ev.evaluate(W, H))
            (_, i4), setup_r, wall_r = warm_and_time(
                lambda: recommend(W[:n], H, k=10, exclude=train[:n]))
    finally:
        for u in undo:
            u()
    with use_mesh(MeshContext.create(ctx.devices[:1])):
        r1 = AoaEvaluator(test, train, k=5).evaluate(W, H)
        _, i1 = recommend(W[:n], H, k=10, exclude=train[:n])
    bad = {k: v for k, v in sets.items() if v != 4}
    require(sets and not bad, f"inputs not spread over 4 devices: {bad}")
    diff = max(abs(r4[k] - r1[k]) for k in r1)
    s64 = rec_scores64(W[:n], H, train[:n])
    ok4, swaps4 = topk_matches(i4, s64, 10)
    ok1, _ = topk_matches(i1, s64, 10)
    return diff <= EVAL_TOL and ok4 and ok1, {
        "setup_s": {"evaluate": setup_e, "recommend": setup_r},
        "wall_s": {"evaluate": wall_e, "recommend": wall_r},
        "compare": f"metrics 4 vs 1 device max|diff| {diff:.3e}; top-10 "
                   f"4 devices vs float64: {swaps4} near-tie rows; "
                   f"{len(sets)} inputs on 4 devices"}


PHASES = {name: globals()["phase_" + name]
          for name in DEFAULT_PHASES + FOUR_PHASES}


# ---------------------------------------------------------------------------

def run_phase(ctx, name) -> bool:
    """Run one phase and print its line; a phase that raises fails."""
    t0 = time.perf_counter()
    try:
        ok, out = PHASES[name](ctx)
    except Exception:  # reported here; main() then exits non-zero
        traceback.print_exc()
        ok, out = False, {"compare": "raised (traceback on stderr)"}
    out["phase_s"] = time.perf_counter() - t0
    out["peak_bytes_in_use"] = ctx.peak()
    compare = out.pop("compare", "")
    print(f"phase {name} [{ctx.card}]: {'PASS' if ok else 'FAIL'} | "
          f"{json.dumps(out)} | {compare}", flush=True)
    return ok


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-device "
                         "comparison")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from cymf_tpu.utils.runtime import (card_info, card_lines,
                                        enable_compile_cache)
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    import jax

    devices = check_devices(jax.devices(), 4 if args.four else 1)
    lines = card_lines()
    print(f"device_kind {devices[0].device_kind}; JAX devices "
          f"{len(jax.devices())}; using {len(devices)}; nvidia-smi name, "
          "power.limit:", flush=True)
    for line in lines:  # exactly as nvidia-smi prints them
        print(line, flush=True)
    ctx = Ctx(args.seed, devices, card_info(lines))
    failed = []
    from cymf_tpu import MeshContext, use_mesh
    # default phases run on the first card alone, whatever else is there
    mesh = use_mesh(MeshContext.create(devices[:1])) if not args.four \
        else contextlib.nullcontext()
    with mesh:
        for name in select_phases(args.four):
            if not run_phase(ctx, name):
                failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
