"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins and is left
to JAX; otherwise the cache sits at a fixed path inside the checkout."""

import os

import jax

from spmv_tpu.utils import cache

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_env_dir_is_used_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(cache, "_enabled", False)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    assert cache._enabled is False


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    assert cache.enable_compile_cache() == cache.DEFAULT_DIR
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
