"""chip_smoke.py and bench.py refuse to run without a GPU: nonzero exit
and no result line; chip_smoke.py also alone in a directory."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,alone", [("chip_smoke.py", False),
                                        ("chip_smoke.py", True),
                                        ("bench.py", False)])
def test_fails_without_gpu(tmp_path, name, alone):
    script = os.path.join(REPO, name)
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert '"metric"' not in out.stdout
