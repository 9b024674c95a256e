"""Where the persistent XLA compilation cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise accelerator runs keep the cache at
one fixed path inside the checkout, ``tests/.jax_cache`` (ignored by
git): the directory is part of what makes an entry findable again, so
every entry point of a checkout shares it.  CPU runs (the tests,
``--cpu`` smoke runs) use no persistent cache.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", ".jax_cache")


def configure_compile_cache(jax_mod) -> str | None:
    """Point ``jax_mod`` at the checkout's cache unless the environment
    names one or the default backend is the CPU.  Returns the directory
    in use, or None when there is no persistent cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax_mod.default_backend() == "cpu":
        return None
    jax_mod.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax_mod.config.update("jax_persistent_cache_min_compile_time_secs",
                          1.0)
    return REPO_CACHE
