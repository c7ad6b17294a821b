"""Process set-up for the scripts that run the library on a GPU.

``enable_compile_cache`` keeps JAX's persistent compilation cache where
``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that variable itself) or,
when it is unset, at the fixed ``<repo>/.jax_cache`` — a fixed path, so a
second process finds what the first one compiled.  ``require_gpu`` makes
a measurement path fail instead of falling back to the CPU, and
``card_info`` reads the card's name and power limit from ``nvidia-smi`` in
a child process that never imports JAX.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Returns the directory of JAX's persistent compilation cache:
    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it; nothing is set
    here), else :data:`DEFAULT_CACHE_DIR`, which this points JAX at."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_gpu():
    """Returns the first JAX device, or exits non-zero unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {dev.platform} ({dev.device_kind})"
        )
    return dev


def card_info() -> str:
    """``name, power.limit`` of each card, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
