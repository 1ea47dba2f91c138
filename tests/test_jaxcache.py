"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR
says, else at one fixed directory inside the checkout; the CLI turns it
on (utils/jaxcache.py)."""
import os
import subprocess
import sys

import jax
import pytest

from sdvpcmdecoder_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    yield
    jaxcache.enable(min_compile_secs=0.5)   # what conftest set


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_picks_directory(monkeypatch, tmp_path, env_dir,
                                restore_cache_config):
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    assert jaxcache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_default_dir_is_ignored_by_git():
    assert str(jaxcache.DEFAULT_DIR.parent) == REPO
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_entries_land_in_env_dir(tmp_path):
    """A fresh process that compiles after enable() writes its entries
    into JAX_COMPILATION_CACHE_DIR."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    code = ("from sdvpcmdecoder_tpu.utils import jaxcache; "
            "jaxcache.enable(0.0); import jax, jax.numpy as jnp; "
            "jax.jit(lambda x: x * 7 + 3)(jnp.arange(9)).block_until_ready()")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=300)
    assert any(n.endswith("-cache") for n in os.listdir(tmp_path))


def test_cli_enables_cache(monkeypatch, tmp_path, restore_cache_config):
    from sdvpcmdecoder_tpu.__main__ import main
    from sdvpcmdecoder_tpu.pipeline import ingest
    from sdvpcmdecoder_tpu.synth import captures
    cap = tmp_path / "c.y4m"
    ingest.write_y4m(cap, captures.stc007_pal_frames(2, 3))
    cache = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
    assert main([str(cap), "-o", str(tmp_path / "c.wav"), "--quality",
                 "fast", "--backend", "native"]) == 0
    assert jax.config.jax_compilation_cache_dir == str(cache)
