"""Process set-up for the measurement entry points (`bench.py`,
`chip_smoke.py`): the persistent compile cache and the card's identity.

Importing the library changes no JAX configuration; only these calls do.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CACHE_DIR_NAME = ".jax_cache"


def enable_compile_cache(checkout: str | os.PathLike) -> str:
    """Give JAX a persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing is changed.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, because the path is part of
    the cache key and a directory that moves never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(Path(checkout).resolve() / CACHE_DIR_NAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_lines() -> list:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card.  Runs as a child process that never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    return [line.strip() for line in out.splitlines() if line.strip()]


def card_info(lines: list | None = None) -> str:
    """The cards' name and power limit (``lines``, else
    :func:`card_lines`) in one line: prefixed ``"<n> x "`` when n cards
    report the same, else joined by ``"; "``."""
    lines = card_lines() if lines is None else lines
    if len(lines) > 1 and len(set(lines)) == 1:
        return f"{len(lines)} x {lines[0]}"
    return "; ".join(lines)


def require_gpu():
    """The local devices, after checking that JAX found a GPU.

    A measurement needs the card: on any other platform this raises
    instead of falling back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (platform {devices[0].platform!r}); this "
            "measures the card and does not run elsewhere")
    return devices
