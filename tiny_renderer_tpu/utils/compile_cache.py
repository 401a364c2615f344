"""Persistent XLA compilation cache for warm starts.

The reference app is ready the instant assets load (src/main.rs:36 —
a CPU renderer has nothing to compile).  Our frame functions JIT-compile
per (pipeline, size, backend), which costs seconds per pipeline.  JAX's
persistent compilation cache removes that cost from every run after the
first: compiled executables are keyed by HLO + compile options + platform
and reloaded from disk.

Where the cache lives: $JAX_COMPILATION_CACHE_DIR when it is set (and no
other directory), else one fixed directory inside the checkout,
`<repo>/.jax_cache` (git-ignored).  The CLI (app.py), bench.py and
chip_smoke.py enable it; `--no-compile-cache` disables it in the CLI.
Library users call `enable_compile_cache()` themselves if they want it —
importing the package does not mutate global JAX config.
"""

from __future__ import annotations

import os
import sys

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def default_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR if set, else `<repo>/.jax_cache`."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at default_cache_dir()
    (created if needed).

    Caches every compile regardless of duration/size — the renderer's
    frame functions are exactly the executables worth keeping.  Returns
    the directory in use, or None if the cache could not be enabled
    (unwritable path) — rendering proceeds uncached in that case.
    """
    import jax

    path = default_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        # Thresholds first, cache dir LAST: the dir setting is what turns
        # the cache on, so a partial failure leaves it fully disabled
        # (matching the message below) rather than half-configured.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        jax.config.update("jax_compilation_cache_dir", path)
    except Exception as e:  # pragma: no cover - depends on host FS
        # stderr: bench.py's stdout is a one-JSON-line contract.
        print(f"compilation cache disabled ({e})", file=sys.stderr)
        return None
    return path
