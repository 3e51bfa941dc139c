"""Iterative solvers on the handle API — the execute-many workload.

The reference's vestigial ITSOL heritage (src/samples/data-types.h:30-302
declares CSR/VBCSR/ILU structs and FGMRES/BiCGSTAB enums that nothing uses)
points at the intended workload: Krylov solvers calling SpMV hundreds of
times per matrix.  This module makes that first-class: the handle compiles
once, the whole solver loop lives in ONE `lax.while_loop` on device (so the
host synchronizes once per solve, not per iteration).

All solvers accept either an :class:`~spmv_tpu.handle.SpmvHandle` or any
``x -> y`` callable (e.g. a distributed plan from ``spmv_tpu.parallel``).
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["cg", "bicgstab", "power_iteration"]


def _as_fn(a) -> Callable:
    bound = getattr(a, "_bound", None)
    if bound is not None:
        return bound
    return a


def cg(a, b, tol: float = 1e-6, maxiter: int = 1000,
       x0=None) -> Tuple[jax.Array, float, int]:
    """Conjugate gradients for SPD A.  Returns (x, residual_norm, iters)."""
    spmv = _as_fn(a)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - spmv(x)

    def body(state):
        x, r, p, rs, it = state
        ap = spmv(p)
        alpha = rs / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, it + 1

    def cond(state):
        _, _, _, rs, it = state
        return jnp.logical_and(rs > tol * tol, it < maxiter)

    state = (x, r, r, jnp.vdot(r, r), jnp.asarray(0))
    x, _, _, rs, iters = jax.lax.while_loop(cond, body, state)
    return x, float(jnp.sqrt(rs.real)), int(iters)


def bicgstab(a, b, tol: float = 1e-6, maxiter: int = 1000,
             x0=None) -> Tuple[jax.Array, float, int]:
    """BiCGSTAB for general (nonsymmetric) A.

    The algorithm the reference's data-types.h enum names (`BICGSTAB`),
    actually implemented.  Returns (x, residual_norm, iters).
    """
    spmv = _as_fn(a)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - spmv(x)
    rhat = r
    eps = jnp.asarray(1e-30, r.dtype)

    def body(state):
        x, r, p, v, rho, alpha, omega, it = state
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / jnp.where(rho == 0, eps, rho)) \
            * (alpha / jnp.where(omega == 0, eps, omega))
        p = r + beta * (p - omega * v)
        v = spmv(p)
        alpha = rho_new / jnp.vdot(rhat, v)
        s = r - alpha * v
        t = spmv(s)
        tt = jnp.vdot(t, t)
        omega = jnp.where(tt == 0, 0.0, jnp.vdot(t, s) / tt)
        x = x + alpha * p + omega * s
        r = s - omega * t
        return x, r, p, v, rho_new, alpha, omega, it + 1

    def cond(state):
        _, r, _, _, _, _, _, it = state
        return jnp.logical_and(jnp.vdot(r, r) > tol * tol, it < maxiter)

    one = jnp.asarray(1.0, r.dtype)
    state = (x, r, jnp.zeros_like(r), jnp.zeros_like(r), one, one, one,
             jnp.asarray(0))
    out = jax.lax.while_loop(cond, body, state)
    x, r = out[0], out[1]
    return x, float(jnp.sqrt(jnp.vdot(r, r).real)), int(out[-1])


def power_iteration(a, n: int = None, iters: int = 100,
                    seed: int = 0) -> Tuple[float, jax.Array]:
    """Dominant eigenvalue/vector via repeated SpMV (square A)."""
    spmv = _as_fn(a)
    if n is None:
        n = a.n                       # works for handles and dist plans
    dtype = np.float64 if getattr(a, "dtype", np.float32) == np.float64 \
        else np.float32
    v = jnp.asarray(np.random.default_rng(seed).standard_normal(n)
                    .astype(dtype))

    def body(i, v):
        w = spmv(v)
        return w / jnp.linalg.norm(w)

    v = jax.lax.fori_loop(0, iters, body, v / jnp.linalg.norm(v))
    lam = jnp.vdot(v, spmv(v))
    return float(lam.real), v
