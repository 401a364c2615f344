"""Persistent compilation cache: warm CLI starts (utils/compile_cache.py).

The reference app has no compile step (src/main.rs:36 — CPU renderer);
ours JIT-compiles per (pipeline, size, backend).  The cache makes repeat
CLI invocations skip that cost.  These tests pin: the cache directory
($JAX_COMPILATION_CACHE_DIR, else one fixed path inside the checkout),
the enable helper's config effect and return contract, the CLI populating
the cache on a cold run and rendering identically on a warm one, and
--no-compile-cache leaving JAX config untouched.
"""

import os

import jax
import numpy as np
import pytest

from tiny_renderer_tpu.app import main
from tiny_renderer_tpu.utils.compile_cache import (
    REPO_CACHE_DIR,
    default_cache_dir,
    enable_compile_cache,
)


@pytest.fixture
def restore_cache_config():
    """Snapshot and restore the JAX cache config around a test.  JAX opens
    its persistent cache once, at the first compile after a directory is
    set; resetting it on both sides lets the test's directory take effect
    and leaves the suite's own cache as it was.  The in-memory executables
    of earlier tests are dropped too, so a "cold" run really compiles."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    saved = {
        name: getattr(jax.config, name)
        for name in (
            "jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes",
        )
    }
    cc.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        cc.reset_cache()


def test_enable_creates_dir_and_sets_config(
    tmp_path, monkeypatch, restore_cache_config
):
    target = tmp_path / "xla_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert enable_compile_cache() == str(target)
    assert target.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_default_dir_honors_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "via_env"))
    assert default_cache_dir() == str(tmp_path / "via_env")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    # Unset: one fixed directory inside the checkout, never the home dir.
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert default_cache_dir() == os.path.join(repo, ".jax_cache")
    assert default_cache_dir() == REPO_CACHE_DIR


def test_cli_cold_run_populates_cache_and_warm_run_matches(
    tmp_path, monkeypatch, restore_cache_config, asset_root
):
    cache = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
    out1 = tmp_path / "cold.png"
    out2 = tmp_path / "warm.png"
    base = [
        "-p", os.path.join(asset_root, "african_head"), "-s", "default",
        "--size", "64", "64", "--frames", "1", "--backend", "jnp", "--no-fps",
    ]
    assert main(base + ["--save", str(out1)]) == 0
    entries = os.listdir(cache)
    assert entries, "cold run should write compiled executables to the cache"
    # Warm run: same pixels from cache-loaded executables.
    assert main(base + ["--save", str(out2)]) == 0
    a = np.fromfile(out1, np.uint8)
    b = np.fromfile(out2, np.uint8)
    assert a.shape == b.shape and (a == b).all()


def test_cli_no_compile_cache_leaves_config_alone(tmp_path, asset_root):
    before = jax.config.jax_compilation_cache_dir
    rc = main([
        "-p", os.path.join(asset_root, "african_head"), "-s", "default", "--size", "48", "48", "--frames", "1",
        "--backend", "jnp", "--no-fps", "--no-compile-cache",
        "--save", str(tmp_path / "f.png"),
    ])
    assert rc == 0
    assert jax.config.jax_compilation_cache_dir == before
