"""Device mesh and sharding layout for cymf-tpu.

The reference library's only parallelism is single-node OpenMP threads over
samples with lock-free shared-memory parameter updates (Hogwild,
`/root/reference/cymf/bpr.pyx:162`, `/root/reference/cymf/util.h:13-21`).
The replacement is SPMD over a :class:`jax.sharding.Mesh`:

* **Embedding tables** (``W``: users x K, ``H``: items x K) are *row-sharded*
  across the mesh axis ``"d"`` — the analogue of a parameter server /
  model-parallel layout.  XLA inserts the all-gather / all-to-all collectives
  needed when a training step gathers arbitrary rows.
* **Interaction batches** are sharded across the same axis (data parallel).
* Dense reductions (Gramians ``HᵀH`` for ALS, loss sums) become ``psum``-style
  collectives that XLA derives automatically from the shardings.

Everything below is layout policy only — models never talk to devices
directly, they request shardings from a :class:`MeshContext`.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "d"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op for single-process runs).

    The reference has no multi-process story at all (SURVEY.md §5); this is
    the entry point for running one process per host over several hosts.  Safe to call
    unconditionally: falls through when no coordinator is configured.
    """
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


@dataclass(frozen=True)
class MeshContext:
    """A 1D device mesh plus the canonical shardings used by every model."""

    mesh: Mesh

    @classmethod
    def create(cls, devices: Optional[Sequence[jax.Device]] = None) -> "MeshContext":
        if devices is None:
            devices = jax.devices()
        return cls(mesh=Mesh(np.asarray(devices), (ROW_AXIS,)))

    @property
    def num_devices(self) -> int:
        return self.mesh.devices.size

    # -- canonical shardings -------------------------------------------------
    def table(self) -> NamedSharding:
        """Row-sharded embedding table / optimizer-state layout."""
        return NamedSharding(self.mesh, P(ROW_AXIS, None))

    def vector(self) -> NamedSharding:
        """Sharded 1D per-row vector (e.g. GloVe biases, propensities)."""
        return NamedSharding(self.mesh, P(ROW_AXIS))

    def batch(self) -> NamedSharding:
        """Data-parallel 1D batch of sample indices."""
        return NamedSharding(self.mesh, P(ROW_AXIS))

    def batch2d(self) -> NamedSharding:
        """(steps, batch) epoch layout: shard the batch dim, steps replicated."""
        return NamedSharding(self.mesh, P(None, ROW_AXIS))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    # -- placement helpers ---------------------------------------------------
    def put_table(self, x):
        return jax.device_put(x, self.table())

    def put_replicated(self, x):
        return jax.device_put(x, self.replicated())

    def pad_rows(self, n: int) -> int:
        """Rows are padded to a multiple of the mesh size so row-sharding is
        even.  Models allocate tables with ``pad_rows(num_rows)`` rows and
        expose only the first ``num_rows`` to users."""
        d = self.num_devices
        return ((n + d - 1) // d) * d


def fetch_to_host(x) -> np.ndarray:
    """numpy copy of ``x``, correct for multi-process (multi-host) arrays.

    A row-sharded table on a multi-process mesh spans non-addressable
    devices; ``np.asarray`` on it raises.  ``process_allgather`` pulls
    every shard to every host (tables are host-visible state in the
    sklearn-style API: ``model.W``/``model.H`` exist on all hosts, exactly
    like the reference's shared-memory arrays)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


_local = threading.local()


def current_mesh() -> MeshContext:
    """The ambient MeshContext (defaults to all local devices)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        ctx = MeshContext.create()
        _local.ctx = ctx
    return ctx


@contextlib.contextmanager
def use_mesh(ctx: MeshContext):
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev
