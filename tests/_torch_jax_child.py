"""What a spawned process that runs the JAX package sets before its first
compile: the test suite's persistent compilation cache, which
``tests/conftest.py`` sets in the test processes only, so that a later
run of the suite loads the JAX package's compiled steps from disk
instead of compiling them again. Imports jax only when called."""
import os


def use_suite_cache():
    """Point this process's JAX at the suite's compilation cache, with
    ``tests/conftest.py``'s settings."""
    import jax
    cache = os.environ.get("REGCM_TPU_JAX_CACHE",
                           os.path.expanduser("~/.cache/regcm_tpu_jax"))
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
