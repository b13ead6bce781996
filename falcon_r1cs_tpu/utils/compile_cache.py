"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench.py, chip_smoke.py, the CLI, the
examples, the tools and the tests): when ``JAX_COMPILATION_CACHE_DIR``
is set, JAX uses that directory and nothing here names another;
otherwise the cache lives at the fixed path ``<checkout>/.jax_cache``
(gitignored).  A fixed path matters because the path is part of the
cache key: a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its directory (call before the
    first compile); returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
