"""Implicit-feedback dataset base (JAX-framework rebuild of the role of
`/root/reference/cymf/dataset/implicit.py` — the attribute contract only;
the helpers are new code).

Holds train/valid/test ``scipy.sparse.lil_matrix`` splits plus user/item
counts; concrete loaders (MovieLens, YahooMusic) fill them in.  The cache
root is ``~/.cymf_tpu`` (the reference caches under ``~/.cymf``), shared
by every loader through :func:`cache_root`.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from scipy import sparse

CACHE_DIR_NAME = ".cymf_tpu"


def cache_root() -> Path:
    """The framework-wide dataset cache directory, created on first use.

    Overridable with ``CYMF_TPU_CACHE`` so tests and provisioning scripts
    can point every loader at a scratch directory.
    """
    override = os.environ.get("CYMF_TPU_CACHE")
    root = Path(override) if override else Path.home() / CACHE_DIR_NAME
    root.mkdir(parents=True, exist_ok=True)
    return root


class ImplicitFeedbackDataset:
    """Base for binarized implicit-feedback datasets.

    Subclasses populate ``train``/``valid``/``test`` (lil matrices of
    shape ``num_user x num_item``) and call :meth:`_finalize`.
    """

    num_user: int
    num_item: int
    train_size: int
    valid_size: int
    test_size: int
    train: sparse.lil_matrix
    valid: sparse.lil_matrix
    test: sparse.lil_matrix

    def __init__(self, dir_name: str, min_rating: float = 4.0) -> None:
        self.root = cache_root()
        self.dir_path = self.root / dir_name
        self.min_rating = float(min_rating)

    def to_matrix(self, df: "pd.DataFrame") -> sparse.lil_matrix:
        """(user, item, rating) frame -> lil_matrix, built vectorized
        through COO instead of a per-entry Python loop."""
        # duplicate (u, i) pairs: lil assignment keeps the last value, COO
        # sums — deduplicate keeping the last occurrence to match.
        dedup = df.drop_duplicates(subset=["user", "item"], keep="last")
        m = sparse.coo_matrix(
            (dedup["rating"].values,
             (dedup["user"].values.astype(np.int64),
              dedup["item"].values.astype(np.int64))),
            shape=(self.num_user, self.num_item))
        return m.tolil()

    def to_dataframe(self, matrix) -> "pd.DataFrame":
        """Matrix -> long-form ``(user, item, rating)`` frame.

        API parity with the reference's helper
        (`/root/reference/cymf/dataset/implicit.py:47-51`), including its
        quirk: the filter is ``rating >= 0``, so ZERO cells are kept and
        the frame enumerates every (user, item) cell unless a rating is
        negative.  Built vectorized from a dense view (the reference
        stacks ``matrix.toarray()`` too, so the memory profile matches).
        """
        import pandas as pd  # only the file-based loaders need pandas

        dense = np.asarray(
            matrix.toarray() if sparse.issparse(matrix) else matrix)
        U, I = dense.shape
        df = pd.DataFrame({
            "user": np.repeat(np.arange(U), I),
            "item": np.tile(np.arange(I), U),
            "rating": dense.ravel(),
        })
        return df[df["rating"] >= 0]

    def split(self, df: "pd.DataFrame"):
        """Frame -> ``(user, item, rating[:, None])`` arrays
        (`/root/reference/cymf/dataset/implicit.py:53-54`)."""
        return (df.user.values, df.item.values, df.rating.values[:, None])

    def _finalize(self):
        self.train_size = self.train.nnz
        self.valid_size = self.valid.nnz
        self.test_size = self.test.nnz
