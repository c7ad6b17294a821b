"""Process set-up (compile cache, GPU requirement) and a guard that no
TPU-only code path comes back."""

import pathlib
import re

import jax
import pytest

from primus_fhe_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_cache_dir_follows_the_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_cache_dir_is_fixed_and_ignored():
    """The same path in every process (no pid, time or temp name), and
    git does not track it."""
    assert runtime.DEFAULT_CACHE_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        runtime.require_gpu()


def _program_files():
    files = sorted((REPO / "primus_fhe_tpu").rglob("*.py"))
    files += sorted(REPO.glob("bench*.py"))
    files += [REPO / "chip_smoke.py", REPO / "__graft_entry__.py"]
    return files


@pytest.mark.parametrize("pattern", [
    r"pallas\.tpu|pltpu",  # Mosaic-TPU kernels
    r"\binterpret\s*=",  # interpreted Pallas kernels
    r"""default_backend\(\)\s*[!=]=\s*["']tpu["']""",  # per-platform branches
    r"""platform\s*[!=]=\s*["']tpu["']""",
])
def test_no_tpu_only_code(pattern):
    hits = [
        f"{p.relative_to(REPO)}:{i}"
        for p in _program_files()
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line)
    ]
    assert not hits, hits


def test_kernel_package_is_gone():
    assert not (REPO / "primus_fhe_tpu" / "ops").exists()
