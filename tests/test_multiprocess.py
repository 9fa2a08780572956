"""Multi-process (2-controller) distributed smoke — exercises
``initialize_distributed`` + global-mesh training end to end on the CPU
backend (no accelerator needed).  Heavy (spawns 2 jax processes), so marked slow."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_fit_matches_single_process():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "multiprocess_smoke.py")],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2-process result == single-process result" in out.stdout
