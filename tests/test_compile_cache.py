"""Where the persistent compilation cache lives."""
import os

import jax

from clima_oceananigans_jl_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restoring_config(fn):
    old = jax.config.jax_compilation_cache_dir
    try:
        return fn()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_honours_jax_compilation_cache_dir(tmp_path, monkeypatch):
    target = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    assert compile_cache.cache_dir() == target

    def enable():
        compile_cache.enable_persistent_cache()
        return jax.config.jax_compilation_cache_dir
    assert _restoring_config(enable) == target
    assert os.path.isdir(target)


def test_cache_defaults_to_one_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.cache_dir()
    assert first == compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

    def enable():
        compile_cache.enable_persistent_cache()
        return jax.config.jax_compilation_cache_dir
    assert _restoring_config(enable) == first
