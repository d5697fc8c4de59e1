"""Multi-host tier as REAL separate processes: 2 jax.distributed workers
(CPU backend, 4 virtual devices each) over a localhost coordination
service, solving the coupled hierarchical PGO and agreeing with the
single-device solve. Exercises the ``jax.process_count() > 1`` branches of
``multihost.make_hybrid_mesh`` / ``initialize_from_env`` that no
single-process test can reach (round-2 verdict: that code had never run).

The workers are fresh subprocesses with their own XLA runtimes, so this
test is independent of the parent's 8-device conftest configuration.
"""

import json
import os
import subprocess
import sys

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "run_multihost_pgo.py")


def test_two_process_pgo_agrees_with_single_device():
    out = subprocess.run(
        [sys.executable, SCRIPT, "--n-poses", "48", "--n-iter", "15",
         "--timeout", "480"],
        capture_output=True, text=True, timeout=560)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    payload = json.loads(out.stdout[out.stdout.index("{"):])
    assert payload["ok"] is True
    r0 = payload["results"]["0"]
    assert r0["max_abs_diff_vs_single"] < 1e-4
    assert r0["rmse_vs_gt"] < 0.02
