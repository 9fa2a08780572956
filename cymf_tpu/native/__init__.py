"""Native (C++) host-side components.

The reference's native layer is its Cython/OpenMP compute kernels; in the
JAX design the compute path is XLA, and the native layer covers
the host-side runtime instead — currently the co-occurrence builder
(`_native.so`, built from ``_native.cpp`` via ``python setup.py build_ext``
or ``make native``).  Pure-python fallbacks exist for every entry point, so
an unbuilt tree stays fully functional.
"""

from __future__ import annotations

import numpy as np

try:
    from . import _native  # type: ignore[attr-defined]
    HAVE_NATIVE = True
except ImportError:
    _native = None
    HAVE_NATIVE = False


def cooccurrence(lines_ids, vocab_size: int, window_size: int):
    """Left-window 1/distance co-occurrence accumulation.

    Returns (keys int64[nnz], values float64[nnz]) with
    ``key = center + context * vocab_size`` (layout of
    `/root/reference/cymf/glove.pyx:226`).
    """
    if not HAVE_NATIVE:
        raise ImportError("native extension not built")
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(x, dtype=np.int64) for x in lines_ids])
        if lines_ids else np.zeros(0, np.int64))
    lens = np.ascontiguousarray(
        np.asarray([len(x) for x in lines_ids], dtype=np.int64))
    keys_b, vals_b = _native.cooccurrence(flat, lens, int(vocab_size),
                                          int(window_size))
    keys = np.frombuffer(keys_b, dtype=np.int64)
    vals = np.frombuffer(vals_b, dtype=np.float64)
    return keys, vals
