"""The one compile-cache rule shared by the CLI, bench, smoke run and tests."""

import os

import jax

from dbot_ros_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured_and_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    expected = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.checkout_root() == ROOT
    assert compile_cache.configure_compile_cache() == expected
    assert compile_cache.configure_compile_cache() == expected
    assert calls == [("jax_compilation_cache_dir", expected)] * 2
