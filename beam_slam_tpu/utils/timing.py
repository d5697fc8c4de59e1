"""Dispatch-amortized device timing.

Single-call `block_until_ready` timings include the host dispatch latency,
not only kernel time. `amortized_median_ms` chains
``inner`` calls of the function inside one jitted ``lax.scan`` whose carry
feeds back into the inputs, so XLA cannot hoist the body out as
loop-invariant, and divides the wall time by ``inner`` — the same approach
bench.py uses for the headline cycle number. Per-stage numbers measured this
way sum to ≈ the full-pipeline cycle (dispatch appears once per *chain*, not
once per call).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def _default_perturb(args, acc):
    """Make every float leaf of ``args`` depend on the scan carry with an
    inert +0.0*acc (keeps values bit-identical, defeats loop hoisting)."""
    def bump(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x + (0.0 * acc).astype(x.dtype)
        return x
    return jax.tree_util.tree_map(bump, args)


def amortized_median_ms(fn: Callable, *args, perturb: Optional[Callable] = None,
                        n_rep: int = 8, inner: Optional[int] = None) -> float:
    """Median per-call milliseconds of ``fn(*args)`` with host->device
    dispatch amortized over ``inner`` chained calls.

    ``inner`` is chosen adaptively when omitted: the chain must run long
    enough (~0.5 s) that the fixed per-call dispatch is a negligible share
    of the measurement — a fixed ``inner`` floors every stage at
    dispatch/inner and cannot rank sub-ms kernels.

    ``perturb(args_tuple, acc) -> args_tuple`` must make the inputs depend on
    the f32 scalar carry ``acc``; the default adds an inert 0.0*acc to every
    float leaf.
    """
    if perturb is None:
        perturb = _default_perturb

    def make_chained(length):
        @jax.jit
        def chained(*a):
            def body(acc, _):
                out = fn(*perturb(a, acc))
                first = jax.tree_util.tree_leaves(out)[0]
                return acc + 0.0 * jnp.sum(first.astype(jnp.float32)), None
            acc, _ = jax.lax.scan(body, jnp.zeros(()), None, length=length)
            return acc
        return chained

    def run(chained, length, reps):
        jax.block_until_ready(chained(*args))  # compile + warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(chained(*args))
            times.append((time.perf_counter() - t0) / length)
        times.sort()
        return 1e3 * times[len(times) // 2]

    if inner is not None:
        return run(make_chained(inner), inner, n_rep)
    # pilot at 16 to size the real chain
    pilot = run(make_chained(16), 16, 3)
    length = max(16, min(2048, int(500.0 / max(pilot, 1e-3))))
    if length <= 24:  # pilot already amortized enough
        return pilot
    return run(make_chained(length), length, min(n_rep, 5))


def chained_median_ms(step: Callable, init, n_rep: int = 8,
                      inner: int = 16) -> float:
    """Median per-step ms of a self-feeding step: ``step(state) -> state``
    chained ``inner`` times inside one jit (successive smoother ticks)."""

    @jax.jit
    def chained(s):
        def body(s, _):
            return step(s), None
        out, _ = jax.lax.scan(body, s, None, length=inner)
        return out

    jax.block_until_ready(chained(init))
    times = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(init))
        times.append((time.perf_counter() - t0) / inner)
    times.sort()
    return 1e3 * times[len(times) // 2]
