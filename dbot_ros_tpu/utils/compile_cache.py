"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``
and the test configuration):

  * ``JAX_COMPILATION_CACHE_DIR`` set → JAX reads it itself; nothing is
    set in code;
  * otherwise → ``<checkout>/.jax_cache``, a fixed path (the cache key
    includes it, so a path that moved between runs would never hit).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> str:
    """The directory that holds the ``dbot_ros_tpu`` package."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def compile_cache_dir() -> str:
    """The cache directory the rule above selects."""
    return os.environ.get(ENV_VAR) or os.path.join(checkout_root(),
                                                   ".jax_cache")


def configure_compile_cache() -> str:
    """Apply the rule to this process's JAX config; returns the path."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
