"""Device timing: one protocol that ends in ``block_until_ready``.

XLA constant-folds chained elementwise iterations, and an asynchronous
dispatch returns before the device finishes.  So:

1. wrap the op in a ``fori_loop`` whose carry perturbs the input through a
   non-foldable data dependency,
2. time the second ``block_until_ready`` end to end, divide by iterations.

``time_spmv`` builds that loop around an ``x -> y`` SpMV callable (requires
m == n so y feeds back; benchmark matrices are square, as are the
reference's, test_spmv.c:217).
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["time_op", "time_op_samples", "time_spmv",
           "time_spmv_samples", "time_spmv_chain"]


def time_op_samples(step: Callable, x0, iters: int = 10,
                    repeats: int = 2) -> list:
    """Per-repeat seconds/iteration samples from ONE traced executable.

    The step's captured device arrays (format plans can be hundreds of MB,
    indices included) are hoisted out of the loop program into arguments,
    as a handle call passes them: baked in as constants, XLA could fold
    index arithmetic at compile time and time a different program.
    """
    from jax.extend.core import ClosedJaxpr, jaxpr_as_fun
    closed = jax.make_jaxpr(step)(x0)

    @jax.jit
    def f(x, consts):
        body = jaxpr_as_fun(ClosedJaxpr(closed.jaxpr, consts))
        return jax.lax.fori_loop(0, iters, lambda i, x: body(x)[0], x)

    consts = list(closed.consts)

    jax.block_until_ready(f(x0, consts))          # compile + warm
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x0, consts))
        samples.append((time.perf_counter() - t0) / iters)
    return samples


def time_op(step: Callable, x0, iters: int = 10, repeats: int = 2) -> float:
    """Best seconds/iteration of ``step`` (x -> x-like, data-dependent)."""
    return min(time_op_samples(step, x0, iters=iters, repeats=repeats))


def time_spmv(spmv_fn: Callable, x0, iters: int = 10,
              repeats: int = 3) -> float:
    """Honest s/iter for y = A@x.

    Square matrices carry the renormalized y as the next x (divide by a
    power of two near the max: exact in fp, cannot be folded, keeps values
    finite); rectangular ones keep the x shape and feed back a
    data-dependent scalar from y, like :func:`time_spmv_chain`.
    """
    rect = False
    try:
        rect = spmv_fn(x0).shape != x0.shape
    except Exception:  # noqa: BLE001 — shape probing only
        pass

    if rect:
        def step(x):
            y = spmv_fn(x)
            scale = jnp.exp2(-jnp.ceil(jnp.log2(jnp.maximum(
                jnp.max(jnp.abs(y)), 1e-30))))
            return x * scale
    else:
        def step(x):
            y = spmv_fn(x)
            scale = jnp.exp2(-jnp.ceil(jnp.log2(jnp.maximum(
                jnp.max(jnp.abs(y)), 1e-30))))
            return y * scale

    return time_op(step, x0, iters=iters, repeats=repeats)


def _renorm(y):
    scale = jnp.exp2(-jnp.ceil(jnp.log2(jnp.maximum(
        jnp.max(jnp.abs(y)), 1e-30))))
    return y * scale


def time_spmv_chain(spmv_fn: Callable, x0, iters: int = 10, k: int = 8,
                    repeats: int = 2) -> dict:
    """Chained-k protocol: k DEPENDENT SpMVs per loop iteration.

    Chaining k data-dependent SpMVs (y ← normalize(A@y), genuinely
    sequential work — not foldable) amortizes any fixed per-iteration cost
    of the loop and exposes the per-SpMV cost:

    * ``inclusive`` — T(k)/k: conservative per-SpMV seconds (carries 1/k of
      the per-iteration cost); report as the reference's GFlops column.
    * ``marginal`` — (T(k) − T(1))/(k−1): the steady-state per-SpMV cost
      (the reference's GFlops_fastest role).
    * ``bubble`` — T(1) − marginal: the fixed per-iteration cost.

    Square matrices chain y back as the next x; rectangular ones keep the
    x shape and feed back a data-dependent SCALAR from y (``x ← x·2^-⌈log2
    max|y|⌉``) — still unfoldable/undedupable, so the protocol covers any
    shape (the reference harness only feeds square mtx).
    """
    rect = False
    try:
        rect = spmv_fn(x0).shape != x0.shape
    except Exception:  # noqa: BLE001 — shape probing only
        pass

    def make_step(kk):
        if rect:
            def step(x):
                for _ in range(kk):
                    y = spmv_fn(x)
                    scale = jnp.exp2(-jnp.ceil(jnp.log2(jnp.maximum(
                        jnp.max(jnp.abs(y)), 1e-30))))
                    x = x * scale
                return x
            return step

        def step(x):
            y = x
            for _ in range(kk):
                y = _renorm(spmv_fn(y))
            return y
        return step

    t_k = min(time_op_samples(make_step(k), x0, iters=iters,
                              repeats=repeats))
    t_1 = min(time_op_samples(make_step(1), x0, iters=iters,
                              repeats=repeats))
    marginal = (t_k - t_1) / max(k - 1, 1)
    if marginal <= 0.05 * t_k / k:
        # noise regime (T(k) ≈ T(1), e.g. short chains on slow plans):
        # a near-zero difference would report fantasy "fastest" numbers —
        # fall back to the conservative inclusive rate
        marginal = t_k / k
    return {
        "inclusive": t_k / k,
        "marginal": marginal,
        "bubble": max(t_1 - marginal, 0.0),
        "t_1": t_1,
        "t_k": t_k,
        "k": k,
    }


def time_spmv_samples(spmv_fn: Callable, x0, iters: int = 10,
                      repeats: int = 3) -> list:
    """All per-repeat samples (one compile) — for avg+best reporting."""
    def step(x):
        y = spmv_fn(x)
        scale = jnp.exp2(-jnp.ceil(jnp.log2(jnp.maximum(
            jnp.max(jnp.abs(y)), 1e-30))))
        return y * scale

    return time_op_samples(step, x0, iters=iters, repeats=repeats)
