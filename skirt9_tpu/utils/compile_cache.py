"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench.py, chip_smoke.py, the tests):
when JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing here
changes; otherwise the cache lives at a fixed path inside the checkout,
`<repo>/.jax_cache` (git-ignored), so that repeated runs of one checkout
find their compiled programs again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
