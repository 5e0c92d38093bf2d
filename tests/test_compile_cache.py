"""The persistent compile cache lands where JAX_COMPILATION_CACHE_DIR
says, or in the fixed <repo>/.jax_cache when it is unset. Each case
runs in a child process: the setting is process-global."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
from montecarlopathtracer.utils.compile_cache import enable_compile_cache
path = enable_compile_cache()
jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("with_env", [True, False])
def test_compile_cache_location(tmp_path, with_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if with_env:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        want = os.path.join(ROOT, ".jax_cache")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    path, configured = r.stdout.split()[-2:]
    assert path == want and configured == want
    assert os.path.isdir(want)
    if with_env:
        assert os.listdir(want), "nothing was cached"
