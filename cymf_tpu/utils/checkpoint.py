"""Checkpoint / resume for trainer state.

The reference has no persistence beyond GloVe's word2vec text export and the
in-memory best-weight snapshot (SURVEY.md §5 "Checkpoint / resume").  Here a
checkpoint is a single ``.npz`` holding a flattened pytree: embedding
tables, optimizer state (Adam moments / AdaGrad accumulators), and the epoch
counter — enough to resume a killed ``fit`` exactly where it left off.

npz is deliberate: single-host-readable, no orbax async machinery needed at
these table sizes (the largest supported config, ML-20M d=256, is ~140 MB
per table).  The format is a plain dict of arrays with ``/``-joined pytree
paths, so it round-trips through numpy alone.

:class:`AsyncCheckpointer` overlaps the disk write with training: the
device->host fetch happens synchronously (the consistency point — the
snapshot is of THIS epoch's state), then serialization + atomic rename run
on a background thread while the next epochs proceed.  Trainers use it by
default; ``wait()`` flushes at fit end.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Dict, Tuple

import jax
import numpy as np

_EPOCH_KEY = "__epoch__"
_META_PREFIX = "__meta__/"
_ROWS_PREFIX = "__rows__/"


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _add_meta(flat: Dict[str, np.ndarray], epoch: int,
              meta: Dict[str, Any] | None,
              rows: Dict[str, int] | None) -> None:
    flat[_EPOCH_KEY] = np.asarray(epoch, np.int64)
    for k, v in (meta or {}).items():
        flat[_META_PREFIX + k] = np.asarray(v)
    for k, n in (rows or {}).items():
        flat[_ROWS_PREFIX + k] = np.asarray(n, np.int64)


def save_checkpoint(path: str, state: Any, epoch: int,
                    meta: Dict[str, Any] | None = None,
                    rows: Dict[str, int] | None = None) -> None:
    """Atomically write ``state`` (a pytree of arrays) + epoch to ``path``.

    ``rows`` maps a top-level key of ``state`` to the number of real rows
    its leaves hold (the rest is mesh padding); :func:`load_checkpoint`
    needs it to resume under another row padding."""
    flat = _flatten(state)
    _add_meta(flat, epoch, meta, rows)
    _write_atomic(path, flat)


def _write_atomic(path: str, flat: Dict[str, np.ndarray]) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class AsyncCheckpointer:
    """Background checkpoint writer.

    ``save()`` blocks only for the device->host fetch (consistency) and
    for any still-running previous write (so at most one write is in
    flight and the atomic-rename ordering matches the save order); the
    npz serialization and rename run on a daemon thread.  Call
    ``wait()`` before reading the file or returning from ``fit``.
    Exceptions from the background write re-raise on the next
    ``save()``/``wait()``.
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, path: str, state: Any, epoch: int,
             meta: Dict[str, Any] | None = None,
             rows: Dict[str, int] | None = None) -> None:
        self._join()
        flat = {k: np.asarray(v) for k, v in _flatten(state).items()}
        _add_meta(flat, epoch, meta, rows)

        def run() -> None:
            try:
                _write_atomic(path, flat)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        self._join()


# optimizer-state leaf prefixes of the lane-packed and wide-row engines,
# which are gone; their checkpoints store state in layouts nothing reads
_REMOVED_SCHEMAS = {"owp": "packed", "ohp": "packed", "oww": "wide",
                    "ohw": "wide"}


def load_checkpoint(path: str, like: Any,
                    rows: Dict[str, int] | None = None
                    ) -> Tuple[Any, int, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``like`` (same pytree).

    Returns (state, epoch, meta).  Leaves keep ``like``'s shardings when
    ``like`` holds jax arrays (device_put with matching sharding).

    ``rows`` maps top-level keys of ``like`` to their real row counts, as
    :func:`save_checkpoint` took them.  Where both the checkpoint and
    ``rows`` name a key, the counts must agree: a checkpoint written for
    another matrix raises.  A leaf whose row count alone differs (written
    under another device count, hence another row padding) loads when its
    key's real count is recorded on both sides: the real rows come from
    the checkpoint, the padding rows keep ``like``'s values.  Any other
    shape difference raises.
    """
    rows = rows or {}
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    epoch = int(flat.pop(_EPOCH_KEY, -1))
    meta = {k[len(_META_PREFIX):]: flat.pop(k)
            for k in list(flat) if k.startswith(_META_PREFIX)}
    saved_rows = {k[len(_ROWS_PREFIX):]: int(flat.pop(k))
                  for k in list(flat) if k.startswith(_ROWS_PREFIX)}
    for k in flat:
        schema = _REMOVED_SCHEMAS.get(k.split("/", 1)[0])
        if schema is not None:
            raise ValueError(
                f"checkpoint {path!r} was written in the {schema!r} "
                f"engine's schema (leaf {k!r}); that engine no longer "
                "exists, so its optimizer state cannot be resumed")
    for k, n in rows.items():
        if k in saved_rows and saved_rows[k] != n:
            raise ValueError(
                f"checkpoint {path!r} holds {saved_rows[k]} real rows of "
                f"{k!r}, this fit has {n}: it was written for another "
                "matrix")

    leaves_like, treedef = jax.tree_util.tree_flatten_with_path(like)
    leaves = []
    for path_elems, leaf in leaves_like:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path_elems)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        like_shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != like_shape:
            top = key.split("/", 1)[0]
            n = saved_rows.get(top)
            if (n is None or n != rows.get(top)
                    or arr.ndim != len(like_shape) or arr.ndim == 0
                    or arr.shape[1:] != like_shape[1:]
                    or min(arr.shape[0], like_shape[0]) < n):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape "
                    f"{tuple(arr.shape)}, expected {like_shape}: only the "
                    "padding rows of a leaf with recorded real rows may "
                    "differ")
            pad = np.asarray(leaf)[n:]
            arr = np.concatenate([arr[:n].astype(pad.dtype), pad])
        if hasattr(leaf, "sharding"):
            arr = jax.device_put(arr.astype(leaf.dtype), leaf.sharding)
        leaves.append(arr)
    state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like), leaves)
    return state, epoch, meta
