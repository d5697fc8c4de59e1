"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharding paths (jax.sharding.Mesh over 'submaps'/'factors'
axes) are exercised without accelerators, as prescribed by SURVEY.md §7's
test strategy ("multi-chip tests with --xla_force_host_platform_device_count").
The platform is pinned through jax.config as well as the environment, before
any backend is initialized (conftest import runs before any test module
import). The GPU path is exercised by ``python chip_smoke.py`` on a card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# XLA:CPU's compiler recurses deeply on the big solver graphs and overflows
# the default 8 MB thread stack (observed: segfaults inside libgcc's
# unwinder, killing pytest workers ~40 tests in). glibc sizes new threads'
# stacks from RLIMIT_STACK, so raise it before any compile thread spawns;
# xdist workers inherit the limit.
import resource  # noqa: E402

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
_want = 512 * 1024 * 1024
if _hard == resource.RLIM_INFINITY or _hard >= _want:
    resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache (JAX_COMPILATION_CACHE_DIR, else the
# fixed in-checkout directory): repeated suite runs skip recompiling the big
# solver graphs, the dominant share of the suite's wall time.
from beam_slam_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert jax.device_count() == 8, jax.devices()


_crash_retries = {}


def pytest_handlecrashitem(crashitem, report, sched):
    """Reschedule tests that died with a crashed xdist worker.

    XLA:CPU's compiler sporadically segfaults (libgcc unwinder) in
    long-lived processes that have compiled many distinct kernels; every
    affected test passes in a fresh process. xdist restarts the worker
    (--max-worker-restart) and this hook re-queues the victim test up to
    twice instead of reporting a spurious failure.
    """
    n = _crash_retries.get(crashitem, 0)
    if n < 2:
        _crash_retries[crashitem] = n + 1
        sched.mark_test_pending(crashitem)
        report.outcome = "rescheduled"


@pytest.fixture
def rng():
    return np.random.default_rng(42)
