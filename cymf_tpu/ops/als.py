"""Batched ALS solve primitives (shared by WMF and ExpoMF).

The reference solves one K x K system per user/item row inside an OpenMP
loop, with per-thread ``malloc`` and LAPACK ``dgesv``
(`/root/reference/cymf/wmf.pyx:150-174`, `linalg.pyx:144-163`).  This
formulation batches rows:

* the shared Gramian ``YtY`` is one ``K x K`` matmul (row-sharded ``Y``
  makes this a local matmul + psum);
* per-row rank-``deg`` corrections come from a padded gather of the row's
  positives: ``A_c = A0 + (c-1) * sub^T sub`` as one batched einsum;
* the solves are batched Cholesky (SPD by construction for ``weight >= 1``,
  ``weight_decay > 0``) with an LU (``jnp.linalg.solve``) option mirroring
  the reference's dgesv.

Rows are grouped into degree-bucketed chunks on the host (ascending-degree
sort, pad length rounded to a power of two) so the padded gather stays tight
at ML-20M scale instead of a dense ``rows x max_degree`` matrix.

Every float32 product here passes ``precision=HIGHEST``: without it the GPU
may run it in TF32, whose 10-bit mantissa would dominate the solve error.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

HIGHEST = jax.lax.Precision.HIGHEST


def gramian(Y: jax.Array) -> jax.Array:
    """``Y^T Y`` in float32 at full precision (the shared ALS Gramian)."""
    return jnp.matmul(Y.T, Y, preferred_element_type=jnp.float32,
                      precision=HIGHEST)


def solve_spd_xla(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve via the XLA Cholesky: A [..., K, K], b [..., K]."""
    L = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False)
    return x[..., 0]


def solve_spd_blocked(A: jax.Array, b: jax.Array,
                      block: int = 64) -> jax.Array:
    """Batched SPD solve via a JAX-level blocked Cholesky.

    A blocked left-looking factorization: ``block x block`` diagonal
    Cholesky calls, batched-matmul trailing updates, and explicit
    diagonal-block inverses so that both substitution sweeps are batched
    matmuls too.  Identical solution up to f32 round-off.  Falls back to
    the XLA form when the matrix is not divisible by / larger than
    ``block`` — e.g. the tiny P x P Woodbury capacitance solves.
    ``block`` is a trace-time constant: jitted callers receive it
    through the solver NAME (``cholesky_blocked<block>``, see
    :func:`resolve_chol_solver` / :func:`get_solver`) so it participates
    in the jit cache key.
    """
    K = A.shape[-1]
    if K > block and K % block == 0:
        return _solve_spd_blocked(A, b, block)
    return solve_spd_xla(A, b)


def resolve_chol_solver(solver: str, num_components: int) -> str:
    """Resolve the user-facing ``"cholesky"`` solver name to an explicit
    ``cholesky_xla`` / ``cholesky_blocked<block>`` form per the
    ``CYMF_TPU_ALS_CHOL`` knob (auto|xla|blocked) and the
    ``CYMF_TPU_ALS_CHOL_BLOCK`` block size (default 64).  ``auto`` picks
    the blocked form at K >= 128 and the XLA form below.

    Models call this ONCE per fit so BOTH choices land in every jit
    cache key (the solver string is a static argument everywhere);
    reading env inside a traced function would not retrace on a knob
    change.  When the blocked form cannot engage at the table size
    (``num_components`` not divisible by / larger than the block) the
    XLA name is returned so downstream policy (e.g. the WMF Woodbury
    cap) keys off the solver that actually runs.
    """
    if solver != "cholesky":
        return solver
    import os
    mode = os.environ.get("CYMF_TPU_ALS_CHOL", "auto")
    if mode not in ("auto", "xla", "blocked"):
        raise ValueError("CYMF_TPU_ALS_CHOL must be auto|xla|blocked")
    if mode == "blocked" or (mode == "auto" and num_components >= 128):
        block = int(os.environ.get("CYMF_TPU_ALS_CHOL_BLOCK", "64"))
        if num_components > block and num_components % block == 0:
            return f"cholesky_blocked{block}"
    return "cholesky_xla"


def solve_spd(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve: routed between the XLA and blocked Cholesky
    forms (delegates to :func:`resolve_chol_solver`; for EAGER use —
    jitted model code resolves the name up front instead so knob
    changes retrace)."""
    return get_solver(resolve_chol_solver("cholesky", A.shape[-1]))(A, b)


def get_solver(name: str):
    """Solver-name -> callable, including parameterized
    ``cholesky_blocked<block>`` names (the block size rides the name so
    it is part of every jit cache key)."""
    if name.startswith("cholesky_blocked"):
        suffix = name[len("cholesky_blocked"):]
        return functools.partial(solve_spd_blocked,
                                 block=int(suffix) if suffix else 64)
    return _SOLVERS[name]


def _solve_spd_blocked(A: jax.Array, b: jax.Array,
                       block: int) -> jax.Array:
    """Batched blocked left-looking Cholesky solve (see
    :func:`solve_spd_blocked`).

    The matrix is partitioned into ``nb = K/block`` block rows.  Per
    block column j: the diagonal block (minus its left updates, batched
    einsums) is factorized by the XLA Cholesky at ``block x block`` and
    its inverse is taken once (``block x block`` TriangularSolve), so
    panel formation and both substitution sweeps become batched
    matmuls.  All Python loops are static (nb is a trace-time constant).
    """
    f32 = jnp.float32
    K = A.shape[-1]
    nb = K // block
    lead = A.shape[:-2]
    C = 1
    for d in lead:
        C *= int(d)
    A2 = A.reshape((C, K, K))
    b2 = b.reshape((C, K))

    def dblk(M, i, j):
        return M[:, i * block:(i + 1) * block, j * block:(j + 1) * block]

    def mm(spec, x, y):
        return jnp.einsum(spec, x, y, preferred_element_type=f32,
                          precision=HIGHEST)

    eye = jnp.eye(block, dtype=A2.dtype)

    def diag_factor(Ajj):
        Ljj = jnp.linalg.cholesky(Ajj)
        return Ljj, jax.scipy.linalg.solve_triangular(
            Ljj, jnp.broadcast_to(eye, Ljj.shape), lower=True)

    L = [[None] * nb for _ in range(nb)]
    Dinv = [None] * nb
    for j in range(nb):
        Ajj = dblk(A2, j, j)
        for k in range(j):
            Ajj = Ajj - mm("cab,cdb->cad", L[j][k], L[j][k])
        L[j][j], Dinv[j] = diag_factor(Ajj)
        for i in range(j + 1, nb):
            Aij = dblk(A2, i, j)
            for k in range(j):
                Aij = Aij - mm("cab,cdb->cad", L[i][k], L[j][k])
            # L[i][j] = Aij @ Ljj^{-T}
            L[i][j] = mm("cab,cdb->cad", Aij, Dinv[j])
    # forward substitution: y_j = Ljj^{-1} (b_j - sum_{k<j} L[j][k] y_k)
    y = [None] * nb
    for j in range(nb):
        r = b2[:, j * block:(j + 1) * block]
        for k in range(j):
            r = r - mm("cab,cb->ca", L[j][k], y[k])
        y[j] = mm("cab,cb->ca", Dinv[j], r)
    # backward substitution: x_j = Ljj^{-T} (y_j - sum_{k>j} L[k][j]^T x_k)
    x = [None] * nb
    for j in range(nb - 1, -1, -1):
        r = y[j]
        for k in range(j + 1, nb):
            r = r - mm("cba,cb->ca", L[k][j], x[k])
        x[j] = mm("cba,cb->ca", Dinv[j], r)
    out = jnp.concatenate(x, axis=-1)
    return out.reshape(lead + (K,))


def solve_lu(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched LU solve (the reference's dgesv analogue)."""
    return jnp.linalg.solve(A, b[..., None])[..., 0]


# NOTE: the bare "cholesky" entry is the deterministic XLA form — an
# UNRESOLVED name reaching a jitted solver lookup must not capture env
# state at trace time (stale-cache hazard); auto routing happens in
# resolve_chol_solver / the eager solve_spd.
_SOLVERS = {"cholesky": solve_spd_xla, "cholesky_xla": solve_spd_xla,
            "lu": solve_lu}


class AlsChunk(NamedTuple):
    """One degree-bucketed chunk of rows to solve together."""
    rows: np.ndarray      # int32[C] target row ids (sentinel = drop)
    idx_pad: np.ndarray   # int32[C, P] padded positive indices into Y
    valid: np.ndarray     # bool[C, P]
    weights: np.ndarray   # float32[C, P] per-entry confidence weights (X data)


def build_chunks(X: sparse.csr_matrix, chunk_size: int, drop_sentinel: int,
                 max_elems: int = 1 << 25,
                 num_components: int = 0) -> List[AlsChunk]:
    """Degree-bucketed chunking of CSR rows.

    Rows are sorted by degree ascending; each chunk is padded to the next
    power of two >= its max degree.  The number of rows per chunk shrinks
    for high-degree buckets so the padded gather stays under ``max_elems``
    index entries (prevents (rows x 64k-degree) blowups on ML-20M-scale
    popular items).  Partial chunks are padded with sentinel rows (dropped
    at scatter time).

    ``num_components``: when given, the cap is additionally scaled so the
    GATHERED ``(C, P, K)`` f32 buffer stays under ~2GB — at K=256 and
    ML-20M degrees the index-entry cap alone admitted a ~34GB gather that
    OOM'd device compilation).
    """
    if num_components > 0:
        max_elems = min(max_elems, max((1 << 29) // num_components, 1 << 16))
    n = X.shape[0]
    deg = np.diff(X.indptr)
    order = np.argsort(deg, kind="stable").astype(np.int64)
    chunks: List[AlsChunk] = []
    start = 0
    while start < n:
        # pad length for this chunk is set by its max (=last taken) degree;
        # scan forward while the (rows x pad) footprint stays in budget
        take = 1
        while take < chunk_size and start + take < n:
            pmax = int(deg[order[start + take]])
            P = 1
            while P < max(pmax, 1):
                P *= 2
            if (take + 1) * P > max_elems:
                break
            take += 1
        # round rows-per-chunk down to a power of two so the number of
        # distinct (rows, pad) shapes — and thus compiles — stays small
        p2 = 1
        while p2 * 2 <= take:
            p2 *= 2
        take = p2
        sel = order[start:start + take]
        start += take
        c = len(sel)
        pmax = int(deg[sel].max()) if c else 0
        P = 1
        while P < max(pmax, 1):
            P *= 2
        idx_pad = np.zeros((c, P), dtype=np.int32)
        valid = np.zeros((c, P), dtype=bool)
        weights = np.zeros((c, P), dtype=np.float32)
        rows = np.full(c, drop_sentinel, dtype=np.int32)
        rows[:c] = sel
        for k, r in enumerate(sel):
            lo, hi = X.indptr[r], X.indptr[r + 1]
            d = hi - lo
            idx_pad[k, :d] = X.indices[lo:hi]
            valid[k, :d] = True
            weights[k, :d] = X.data[lo:hi]
        chunks.append(AlsChunk(rows, idx_pad, valid, weights))
    return chunks


@functools.partial(jax.jit, static_argnames=("solver",))
def wmf_chunk_solve(Y, A0, idx_pad, valid, weight, *, solver: str):
    """Solve one WMF chunk: per row r,
    A = A0 + (weight-1) * sum_{i in pos(r)} y_i y_i^T,  b = weight * sum y_i
    (`wmf.pyx:161-168`).  Rows with no positives return zeros
    (`wmf.pyx:154-156`)."""
    sub = Y[idx_pad] * valid[..., None].astype(Y.dtype)       # (C, P, K)
    A = A0[None] + (weight - 1.0) * jnp.einsum(
        "cpk,cpl->ckl", sub, sub, preferred_element_type=jnp.float32,
        precision=HIGHEST)
    b = weight * jnp.sum(sub, axis=1)
    x = get_solver(solver)(A, b)
    nonempty = jnp.any(valid, axis=1, keepdims=True)
    return jnp.where(nonempty, x, 0.0)


@functools.partial(jax.jit, static_argnames=("solver",))
def wmf_chunk_solve_woodbury(Y, A0inv, idx_pad, valid, weight, *,
                             solver: str = "cholesky"):
    """WMF chunk solve via the Woodbury identity.  Identical solution to
    :func:`wmf_chunk_solve`:

        x = (A0 + (c-1) U U^T)^{-1} (c U 1)
          = A0i b - T (I/(c-1) + U^T T)^{-1} (U^T A0i b),  T = A0i U

    Why: the standard form factorizes a K x K system per row, while every
    large product here (``A0i U``, ``U^T T``) contracts over ``K`` and
    leaves only a batched P x P Cholesky — cheaper when the degree pad
    ``P`` is small next to ``K``.  The trainer routes chunks with small
    ``P`` here and large-``P`` chunks to the standard form.

    ``A0inv`` is the inverse of the half-sweep's shared
    ``Y^T Y + wd I`` (one K x K inversion per half-sweep).  Requires
    ``weight > 1`` (the reference default is 10, `wmf.pyx:46`).
    Accuracy note: the explicit f32 inverse loses ~cond(A0)*eps digits;
    the trainer's auto routing therefore requires ``weight_decay >=
    1e-3`` (cond <= ~||YtY||/wd) and keeps the Cholesky standard form
    otherwise.
    """
    mask = valid[..., None].astype(Y.dtype)
    Ug = Y[idx_pad] * mask                                  # (C, P, K)
    return woodbury_core(Ug, A0inv, valid, weight, solver)


def woodbury_core(sub, A0inv, valid, weight, solver: str):
    """The Woodbury solve on already-gathered, mask-zeroed rows ``sub``
    (C, P, K) — shared by :func:`wmf_chunk_solve_woodbury` and the
    shard_map chunk solver (which resolves rows collectively)."""
    def mm(spec, x, y):
        return jnp.einsum(spec, x, y, preferred_element_type=jnp.float32,
                          precision=HIGHEST)

    b = weight * jnp.sum(sub, axis=1)                       # (C, K)
    T = mm("kl,cpl->cpk", A0inv, sub)                       # (C, P, K)
    P = sub.shape[1]
    M = (jnp.eye(P, dtype=jnp.float32) / (weight - 1.0)
         + mm("cpk,cqk->cpq", sub, T))
    A0ib = mm("kl,cl->ck", A0inv, b)
    UtA0ib = mm("cpk,ck->cp", sub, A0ib)
    # padded (all-invalid) P positions contribute zero rows to M; the
    # identity diagonal keeps it SPD, and their z entries multiply zero
    # columns of T — the padding is self-cancelling
    z = get_solver(solver)(M, UtA0ib)
    x = A0ib - mm("cpk,cp->ck", T, z)
    nonempty = jnp.any(valid, axis=1, keepdims=True)
    return jnp.where(nonempty, x, 0.0)


def place_device_chunks(mesh, chunks: List[AlsChunk]) -> List[AlsChunk]:
    """Device placement for ALS chunks: replicated on one device; on a
    mesh the chunk-row dim of ``idx_pad``/``valid`` is sharded (the
    shard_map solves partition systems over devices) after padding C to
    a mesh multiple with sentinel rows (never owned, valid all-False).
    ``rows``/``weights`` stay replicated (the scatter targets them from
    every shard)."""
    n = mesh.num_devices
    if n == 1:
        return [AlsChunk(jnp.asarray(c.rows), jnp.asarray(c.idx_pad),
                         jnp.asarray(c.valid), jnp.asarray(c.weights))
                for c in chunks]
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import ROW_AXIS
    sh2 = NamedSharding(mesh.mesh, P(ROW_AXIS, None))
    rep = mesh.put_replicated
    out = []
    for c in chunks:
        C = len(c.rows)
        Cp = -(-C // n) * n
        pad = Cp - C
        rows = np.pad(c.rows, (0, pad), constant_values=np.int32(2**31 - 1))
        out.append(AlsChunk(
            rep(jnp.asarray(rows)),
            jax.device_put(jnp.asarray(
                np.pad(c.idx_pad, ((0, pad), (0, 0)))), sh2),
            jax.device_put(jnp.asarray(
                np.pad(c.valid, ((0, pad), (0, 0)))), sh2),
            rep(jnp.asarray(np.pad(c.weights, ((0, pad), (0, 0)))))))
    return out
