"""The persistent compilation cache helper: JAX_COMPILATION_CACHE_DIR wins
when set (nothing else is set); otherwise <repo>/.jax_cache, git-ignored."""

import os

import jax
import pytest

from skirt9_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_enable_compile_cache(env_dir, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv(compile_cache.ENV, want)
        # the variable is JAX's own: the helper must leave the config alone
        jax.config.update("jax_compilation_cache_dir", "sentinel")
    try:
        got = compile_cache.enable_compile_cache()
        assert got == want
        if env_dir is None:
            assert jax.config.jax_compilation_cache_dir == want
        else:
            assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_cache_dir_is_git_ignored():
    lines = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in lines
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


def test_entry_points_share_the_helper():
    """Only the helper names a cache directory; every entry point calls
    it."""
    files = ["bench.py", "chip_smoke.py", "__graft_entry__.py",
             os.path.join("tests", "conftest.py"),
             os.path.join("skirt9_tpu", "__main__.py")]
    for f in files:
        text = open(os.path.join(REPO, f)).read()
        assert "JAX_COMPILATION_CACHE_DIR" not in text, f
        assert "jax_compilation_cache_dir" not in text, f
        assert "enable_compile_cache()" in text, f
