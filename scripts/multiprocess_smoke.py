"""Two-process jax.distributed smoke test on the CPU backend.

Exercises ``cymf_tpu.parallel.mesh.initialize_distributed`` — the entry
point for multi-host runs (the reference is strictly
single-process, SURVEY.md §5) — by spawning two controller processes,
each with 4 virtual CPU devices, and running the SAME BPR fit over the
resulting 8-device global mesh.  Process 0 writes its learned tables;
the parent then reruns the fit single-process and asserts the tables
match (the shard_map epoch is deterministic and mesh-size-invariant up
to float reduction order).

Usage:
  python scripts/multiprocess_smoke.py            # parent: spawn + verify
  (children are launched internally with --process-id)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # standalone invocation from anywhere
    sys.path.insert(0, REPO)
LOCAL_DEVICES = 4
NUM_PROCESSES = 2


def _build_data():
    import numpy as np
    from scipy import sparse
    rng = np.random.default_rng(3)
    U, I = 96, 64
    X = sparse.random(U, I, density=0.15, random_state=13, format="csr",
                      data_rvs=lambda n: np.ones(n))
    X.data[:] = 1.0
    return X


def _fit(out_path: str | None):
    """Runs in every child process (and in-process for the reference)."""
    import numpy as np

    import jax
    from cymf_tpu import BPR
    from cymf_tpu.parallel import MeshContext, use_mesh

    X = _build_data()
    with use_mesh(MeshContext.create(jax.devices())):
        m = BPR(num_components=8, learning_rate=0.02, batch_size=128)
        m.fit(X, num_epochs=4, verbose=False, seed=3)
        W, H = np.asarray(m.W), np.asarray(m.H)
    if out_path and jax.process_index() == 0:
        np.savez(out_path, W=W, H=H)
    return W, H


def child_main(args):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from cymf_tpu.parallel.mesh import initialize_distributed
    initialize_distributed(coordinator_address=args.coordinator,
                           num_processes=NUM_PROCESSES,
                           process_id=args.process_id)
    assert jax.process_count() == NUM_PROCESSES, jax.process_count()
    assert len(jax.devices()) == NUM_PROCESSES * LOCAL_DEVICES
    _fit(args.out)
    print(f"[child {args.process_id}] ok", flush=True)


def parent_main(args):
    port = _free_port()
    coord = f"localhost:{port}"
    out = args.out or os.path.join(tempfile.mkdtemp(), "mp_tables.npz")
    procs = []
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for pid in range(NUM_PROCESSES):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--process-id", str(pid), "--coordinator", coord,
             "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fail = False
    for pid, p in enumerate(procs):
        out_text = p.communicate(timeout=args.timeout)[0].decode()
        if p.returncode != 0:
            fail = True
            print(f"--- child {pid} rc={p.returncode} ---\n{out_text}")
    if fail:
        raise SystemExit("multiprocess children failed")

    # single-process reference on an 8-device mesh in THIS process
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count="
        f"{NUM_PROCESSES * LOCAL_DEVICES}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    W1, H1 = _fit(None)
    with np.load(out) as z:
        W2, H2 = z["W"], z["H"]
    np.testing.assert_allclose(W2, W1, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(H2, H1, rtol=2e-3, atol=2e-5)
    print("multiprocess smoke: 2-process result == single-process result")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args()
    if args.process_id is None:
        parent_main(args)
    else:
        child_main(args)


if __name__ == "__main__":
    main()
