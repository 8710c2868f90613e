"""Process set-up: the compile-cache rule and the GPU requirement."""

import os

import jax
import pytest

from ssnt_tts.utils import runtime


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment_is_left_alone(
        monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_cache_dir_defaults_to_an_ignored_directory_in_the_checkout(
        monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.configure_compile_cache()
    assert got == runtime.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.dirname(got) == runtime.REPO_ROOT
    with open(os.path.join(runtime.REPO_ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.basename(got) + "/" in ignored


def test_require_gpu_refuses_the_cpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()
