#!/usr/bin/env python
"""Stage timings of the batched LM solve at several batch sizes.

Times each stage of the batched LM solve independently at several batch
sizes: full solve, assembly only, damped Schur solve only, Cholesky only,
and the big Schur-product matmul only. Whatever stage's time grows ~linearly
with B while its FLOPs could run in parallel is the flatline culprit.
"""

import sys
import os
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def median_time(fn, *args, reps=5, inner=16, perturb=None):
    """Median per-call seconds; ``perturb(args, acc)`` makes the body depend
    on the scan carry so XLA cannot hoist fn as loop-invariant (bench.py's
    trick), and inner=16 amortizes the per-call dispatch."""
    if perturb is None:
        def perturb(a, acc):
            first = a[0]
            leaf0 = jax.tree_util.tree_leaves(first)[0]
            bumped = jax.tree_util.tree_map(
                lambda x: (x + (0.0 * acc).astype(x.dtype)
                           if jnp.issubdtype(x.dtype, jnp.floating) else x),
                first)
            return (bumped,) + a[1:]

    @jax.jit
    def chained(*a):
        def body(acc, _):
            out = fn(*perturb(a, acc))
            leaf = jax.tree_util.tree_leaves(out)[0]
            return acc + 0.0 * jnp.sum(leaf.astype(jnp.float32)), None
        acc, _ = jax.lax.scan(body, jnp.zeros(()), None, length=inner)
        return acc

    jax.block_until_ready(chained(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(*args))
        ts.append((time.perf_counter() - t0) / inner)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from beam_slam_tpu.solver import gauss_newton as gn
    from beam_slam_tpu.utils import synthetic
    from beam_slam_tpu.parallel import sharded

    losses = (None, None, 1.0, 2.0, 2.0)
    build = jax.jit(lambda k: synthetic.build_lvio_window(
        k, n_kf=40, kf_dt=0.25, with_vision=True, n_landmarks=256,
        obs_per_lm=8, n_idp=64)[:2])
    options = gn.SolverOptions(max_iterations=10, scan_length=10)

    w1, f1 = jax.block_until_ready(build(jax.random.PRNGKey(0)))
    free = jnp.concatenate([w1.dense_free_mask(), jnp.zeros((1,), bool)])
    lm_free = w1.landmarks.active & ~w1.landmarks.held
    D = w1.num_dense_dof
    print(f"dense dof D={D}, landmarks L={w1.landmarks.capacity}")

    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,32")
    ap.add_argument("--stages", default="solve,asm,schur,chol,mm,lin")
    args = ap.parse_args()
    stages = set(args.stages.split(","))

    for B in [int(x) for x in args.batches.split(",")]:
        keys = jax.random.split(jax.random.PRNGKey(1), B)
        wins, fams = jax.block_until_ready(jax.jit(jax.vmap(build))(keys))

        out = [f"B={B:3d}:"]
        if "solve" in stages:
            t_solve = median_time(
                lambda w: sharded.solve_batched(w, fams, losses, options)[0],
                wins)
            out.append(f"solve(10it)={1e3*t_solve:8.2f} ms "
                       f"win/s={B/t_solve:7.1f}")

        assemble = jax.vmap(lambda w, f: gn._assemble(w, f, losses, "scatter"),
                            in_axes=(0, 0))
        if "asm" in stages:
            t_asm = median_time(lambda w: assemble(w, fams), wins)
            out.append(f"asm1={1e3*t_asm:7.2f}")
        need_eqs = stages & {"schur", "chol", "mm"}
        if need_eqs:
            eqs = jax.block_until_ready(jax.jit(
                lambda w: assemble(w, fams))(wins))
            H, g, H_ll, g_l, W, _ = eqs
        if "schur" in stages:
            lam = jnp.asarray(1e-4, H.dtype)
            schur = jax.vmap(lambda h, gg, hll, gl, ww: gn._solve_damped(
                h, gg, free, lam, hll, gl, ww, lm_free))
            t_schur = median_time(lambda *a: schur(*a), H, g, H_ll, g_l, W)
            out.append(f"schur1={1e3*t_schur:7.2f}")
        if "chol" in stages:
            t_chol = median_time(lambda h: jnp.linalg.cholesky(
                h + jnp.eye(h.shape[-1], dtype=h.dtype)[None] * 1e-2), H)
            out.append(f"chol={1e3*t_chol:6.2f}")
        if "mm" in stages:
            t_mm = median_time(
                lambda a: jnp.einsum("bdl,bel->bde", a, a), W)
            out.append(f"WWt={1e3*t_mm:6.2f}")
        if "lin" in stages:
            def lin_only(w, f):
                outs = []
                for fam in f:
                    r, J, *_ = fam.linearize(w)
                    outs.append(jnp.sum(r) + jnp.sum(J))
                return sum(outs)
            t_lin = median_time(
                lambda w: jax.vmap(lin_only, in_axes=(0, 0))(w, fams), wins)
            out.append(f"lin={1e3*t_lin:7.2f}")
        print("  ".join(out), flush=True)


if __name__ == "__main__":
    main()
