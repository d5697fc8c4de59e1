"""compile_cache.enable: JAX_COMPILATION_CACHE_DIR wins, else the fixed
in-checkout directory. Each case runs in a fresh interpreter so the test
process's own cache configuration is untouched."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import json, jax\n"
    "from beam_slam_tpu.utils import compile_cache\n"
    "d = compile_cache.enable()\n"
    "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))\n")


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("from_env", [True, False])
def test_cache_dir(tmp_path, from_env):
    env_dir = str(tmp_path / "cache") if from_env else None
    returned, configured = _probe(env_dir)
    want = env_dir if from_env else os.path.join(REPO, ".jax_cache")
    assert returned == configured == want
