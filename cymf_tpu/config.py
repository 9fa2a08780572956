"""Global configuration for cymf-tpu.

The reference (cymf) computes everything in float64 on CPU
(`/root/reference/cymf/bpr.pyx:87` casts X to float64 and all tables are
``double``).  Here parameters and accumulation are float32 (fast on the
GPU, and well within the numerical needs of K<=512 matrix
factorization).  ``param_dtype`` can be overridden (e.g. to
bfloat16 for bandwidth-bound experiments) via :func:`set_param_dtype`.
"""

from __future__ import annotations

import jax.numpy as jnp

_param_dtype = jnp.float32


def param_dtype():
    """dtype used for embedding tables and optimizer state."""
    return _param_dtype


def set_param_dtype(dtype) -> None:
    global _param_dtype
    _param_dtype = jnp.dtype(dtype)


# Index dtype for user/item ids.  int32 covers every supported dataset
# (ML-20M has 2e7 interactions, 1.4e5 users, 2.7e4 items).
index_dtype = jnp.int32
