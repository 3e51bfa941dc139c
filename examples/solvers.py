"""Iterative solvers on top of the handle API — the execute-many story.

The reference's vestigial ITSOL heritage (src/samples/data-types.h:30-302
declares FGMRES/BiCGSTAB structs nothing uses) points at the intended
workload: Krylov solvers calling SpMV hundreds of times per matrix.  These
examples show the inspect-once/execute-many contract doing that work:
the handle compiles once, every iteration is a device-side call, and the
whole solver loop can live under one ``lax.while_loop``.

Run:  python examples/solvers.py
"""

import os
import sys

# allow `python examples/<name>.py` without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

import spmv_tpu as st


from spmv_tpu.solvers import bicgstab, cg, power_iteration


def main():
    import jax
    from spmv_tpu.io import generate

    # SPD system: diagonally dominant random matrix, in f64 (native on
    # the GPU and the CPU alike).
    dtype = np.float64
    a = generate.diag_plus_random(5000, nnz_per_row=8, seed=1).astype(dtype)
    sym = st.CsrMatrix.from_coo(  # symmetrize: A + A^T
        a.m, a.n,
        np.concatenate([np.repeat(np.arange(a.m), a.row_lengths), a.colidx]),
        np.concatenate([a.colidx, np.repeat(np.arange(a.m), a.row_lengths)]),
        np.concatenate([a.vals, a.vals]) * 0.5)
    h = st.create_handle(sym)
    b = np.random.default_rng(2).standard_normal(sym.n)
    b = b.astype(dtype)
    x, res, iters = cg(h, b, tol=1e-6)
    print(f"CG: method={h.method_name}, {iters} iterations, "
          f"residual {res:.2e}")
    check = np.asarray(st.spmv(h, x)) - np.asarray(b)
    print(f"   |Ax-b| = {np.abs(check).max():.2e}")

    xb, resb, itb = bicgstab(h, b, tol=1e-6)
    print(f"BiCGSTAB: {itb} iterations, residual {resb:.2e}")

    lam, _ = power_iteration(h, iters=50)
    print(f"power iteration: lambda_max ~ {lam:.4f}")


if __name__ == "__main__":
    main()
