"""Process-level JAX configuration: the persistent compilation cache.

Every CLI/bench invocation after the first reuses the compiled programs
from the cache instead of compiling again. Where JAX_COMPILATION_CACHE_DIR
is set, JAX reads it itself and nothing here overrides it; otherwise the
cache lives at one fixed path inside the checkout (`<repo>/.jax_cache`,
listed in .gitignore). JXL_JAX_NO_CACHE=1 disables it. Imported for side
effects by jxl_jax/__init__.py. The platform is JAX's own choice
(JAX_PLATFORMS); a CPU device count for mesh runs is JAX_NUM_CPU_DEVICES.
"""

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str | None:
    """The compilation cache directory this process uses (None: disabled)."""
    if os.environ.get("JXL_JAX_NO_CACHE"):
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def configure_jax() -> None:
    import jax

    path = cache_dir()
    if path is None or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
