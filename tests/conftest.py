"""Shared test config: persistent XLA compilation cache.

The tier-1 suite's floor is XLA compile time for the 10 arch smoke tests;
caching compiled executables on disk (content-addressed by jax itself) cuts
repeat runs roughly in half. Same env convention as the IPC cache:
``REPRO_JAX_CACHE=<dir>`` relocates it, ``REPRO_JAX_CACHE=0`` disables.
"""
import os


def _setup_jax_cache():
    path = os.environ.get("REPRO_JAX_CACHE",
                          os.path.join("artifacts", "jax_cache"))
    if path.strip().lower() in ("", "0", "off", "none", "disable"):
        return
    try:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:            # older jax without the knobs: run uncached
        pass


_setup_jax_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")
