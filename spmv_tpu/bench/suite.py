"""Benchmark + validation suite — the reference harness on the device.

Reproduces the reference's bench/validation flow (``src/samples/test_spmv.c``):
load or synthesize a matrix, compute a golden y, run every requested method,
check RMSE, and emit CSV rows in the reference's exact schema
(test_spmv.c:146-149)::

    matrix,method,vectorized,threads,nnz,rmse,predeal_ms,avg_ms,GFLOPs_avg,GFLOPs_fastest

Differences from the reference, all deliberate:

* timing uses the fori-chained protocol (bench/timing.py) instead of the
  async dispatch loop — the reference's 10+100-iteration scheme
  (test_spmv.c:103-125) would time the enqueue, not the device;
* the ``threads`` column reports the jax device count (thread scheduling is
  XLA's job on the device);
* external baselines (the role of the MKL bench, ``src/samples/mkl_spmv.c``)
  are scipy CSR on the host CPU and ``jax.experimental.sparse`` BCOO and
  CSR on the same device, reported as pseudo-methods ``ScipyCsr`` /
  ``JaxBcoo`` / ``JaxCsr``.  On a GPU, ``JaxCsr`` lowers to cuSPARSE's
  SpMV: the vendor library's time on the same matrix.

CLI::

    python -m spmv_tpu.bench.suite builtin:banded1m builtin:uniform100k
    python -m spmv_tpu.bench.suite path/to/matrix.mtx --methods AUTO,DIA
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Iterable, List, Optional

import numpy as np

from ..types import CsrMatrix, Method, METHOD_NAMES, VECTORIZED_NAMES
from ..oracle import spmv_golden
from .timing import time_spmv_chain

__all__ = ["BUILTIN_MATRICES", "FAMILIES", "family", "load_any",
           "bench_matrix", "main", "CSV_HEADER"]

CSV_HEADER = ("matrix,method,vectorized,threads,nnz,rmse,predeal_ms,"
              "avg_ms,GFLOPs_avg,GFLOPs_fastest")

#: Synthetic stand-ins for the BASELINE.md configs (no SuiteSparse egress).
BUILTIN_MATRICES = {
    "banded1m": lambda dtype: _gen("banded", dtype, 1_000_000),
    "banded4m": lambda dtype: _gen("banded", dtype, 4_000_000),
    "banded100k": lambda dtype: _gen("banded", dtype, 100_000),
    "uniform100k": lambda dtype: _gen("uniform", dtype, 100_000),
    "powerlaw100k": lambda dtype: _gen("powerlaw", dtype, 100_000),
    "uniform10k": lambda dtype: _gen("uniform", dtype, 10_000),
    "clustered200k": lambda dtype: _gen("clustered", dtype, 200_000),
    "blocky": lambda dtype: _gen("blocky", dtype, 0),
    # the bench.py families, mirrored here so the CSV sweep covers them
    # (webbase stand-in: matrices are generated, never downloaded)
    "webbase1m": lambda dtype: _gen("webbase", dtype, 1_000_000),
    "scattered4m": lambda dtype: _gen("scattered4m", dtype, 4_000_000),
}


def _gen(kind: str, dtype, m: int) -> CsrMatrix:
    from ..io import generate
    if kind == "banded":
        return generate.banded(m, m, 4, dtype=dtype, seed=7)
    if kind == "uniform":
        return generate.random_uniform(m, m, 40, dtype=dtype, seed=42)
    if kind == "powerlaw":
        return generate.power_law(m, m, 40 * m, dtype=dtype, seed=2)
    if kind == "clustered":
        return generate.clustered(m, m, 32, spread=512, dtype=dtype, seed=9)
    if kind == "webbase":
        return generate.webbase_like(m, m, 3_100_000, dtype=dtype, seed=11)
    if kind == "scattered4m":
        # scattered scale case: 4M rows, 32M nnz over 262k columns
        return generate.random_uniform(m, 262_144, 8, dtype=dtype, seed=13)
    if kind == "blocky":
        return generate.block_random(16, 16, blocks_per_row=4, fill=0.4,
                                     dtype=dtype, seed=5)
    raise ValueError(kind)


#: the headline families of ``bench.py``, ``chip_smoke.py`` and
#: ``bench_compare.py``: f32 as generated; ``_f64`` keeps the structure and
#: draws standard-normal f64 values
FAMILIES = ("banded4m", "clustered200k", "uniform100k", "powerlaw100k",
            "webbase1m", "uniform100k_f64", "clustered200k_f64",
            "powerlaw100k_f64", "banded1m_f64")


def family(name: str) -> CsrMatrix:
    """One of :data:`FAMILIES`, generated from its fixed seeds."""
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}")
    base = name.removesuffix("_f64")
    a = BUILTIN_MATRICES[base](np.float32)
    if base == name:
        return a
    vals = np.random.default_rng(7).standard_normal(a.nnz)
    return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, vals)


def load_any(spec: str, dtype=np.float32) -> tuple:
    """'builtin:<name>' or a MatrixMarket path → (display_name, CsrMatrix)."""
    if spec.startswith("builtin:"):
        name = spec.split(":", 1)[1]
        return name, BUILTIN_MATRICES[name](dtype)
    from ..io.mmio import load_matrix
    return spec, load_matrix(spec, dtype=dtype)


from ..oracle import rmse as _rmse  # single RMSE definition everywhere


def _row(matrix, method_name, vec_name, threads, nnz, rmse, predeal_ms,
         avg_ms, gflops_avg, gflops_best) -> str:
    return (f"{matrix},{method_name},{vec_name},{threads},{nnz},"
            f"{rmse:.6g},{predeal_ms:.3f},{avg_ms:.6f},"
            f"{gflops_avg:.6f},{gflops_best:.6f}")


def bench_matrix(name: str, a: CsrMatrix,
                 methods: Iterable[Method],
                 iters: int = 10, repeats: int = 2,
                 external: bool = False,
                 split_predeal: bool = False,
                 out=sys.stdout) -> List[str]:
    """Bench one matrix across methods; print + return CSV rows.

    ``split_predeal`` appends ``pack_ms,transfer_ms`` columns (the
    host-pack vs device-transfer split of the predeal, measured via
    ``handle.predeal_profile``); the default
    keeps the reference's exact schema (test_spmv.c:146-149).
    """
    import jax
    import jax.numpy as jnp
    from ..handle import create_handle, predeal_profile

    x = np.random.default_rng(0).standard_normal(a.n).astype(a.dtype)
    golden = spmv_golden(a.astype(np.float64), x.astype(np.float64))
    if np.dtype(a.dtype) == np.float64:
        # fresh-process f64 sweep: without x64 on, jnp.asarray silently
        # downcasts x to f32 and every handle's chained-timing carry then
        # type-mismatches (create_handle enables x64, but only LATER)
        jax.config.update("jax_enable_x64", True)
    xj = jnp.asarray(x)
    threads = len(jax.devices())
    rows = []

    for method in methods:
        t0 = time.perf_counter()
        try:
            if split_predeal:
                with predeal_profile() as laps:
                    h = create_handle(a, method=method)
            else:
                laps = {"transfer_s": 0.0}
                h = create_handle(a, method=method)
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            print(f"# {name},{METHOD_NAMES[Method(method)]}: "
                  f"handle failed: {e}", file=out, flush=True)
            continue
        predeal_ms = (time.perf_counter() - t0) * 1e3
        try:
            y = np.asarray(h._bound(xj))       # compile + correctness
            rmse = _rmse(y, golden)
            t1 = time.perf_counter()           # warm second call: real
            jax.block_until_ready(h._bound(xj))  # per-exec magnitude
            exec_s = time.perf_counter() - t1
            # chained-k protocol (bench/timing.py): avg = inclusive
            # T(k)/k, fastest = marginal (T(k)-T(1))/(k-1).  Slow plans
            # (≥ 0.2 s per exec) keep the chain short: the fixed loop cost
            # is already amortized and a long chain only costs wall time
            k_eff = 8 if exec_s < 0.2 else 2
            iters_eff = iters if exec_s < 0.2 else max(2, iters // 5)
            r = time_spmv_chain(h._bound, xj, iters=iters_eff, k=k_eff,
                                repeats=repeats)
        except Exception as e:  # noqa: BLE001 — keep sweeping
            print(f"# {name},{h.method_name}: exec/timing failed: "
                  f"{str(e).splitlines()[0][:120]}", file=out, flush=True)
            continue
        avg, best = r["inclusive"], r["marginal"]
        row = _row(name, h.method_name, VECTORIZED_NAMES[h.vectorized],
                   threads, a.nnz, rmse, predeal_ms, avg * 1e3,
                   2 * a.nnz / avg / 1e9, 2 * a.nnz / best / 1e9)
        if split_predeal:
            t_ms = laps["transfer_s"] * 1e3
            row += f",{predeal_ms - t_ms:.3f},{t_ms:.3f}"
        print(row, file=out, flush=True)
        rows.append(row)

    if external:
        ext = _external_baselines(name, a, x, golden, iters, out)
        if split_predeal:          # keep the CSV rectangular
            ext = [r + ",," for r in ext]
        rows += ext
    return rows


def _external_baselines(name, a, x, golden, iters, out) -> List[str]:
    """ScipyCsr (host CPU), JaxBcoo and JaxCsr (device): the MKL-bench
    role.  The device rows use the plans' chained protocol."""
    rows = []
    try:
        import scipy.sparse as sp
        s = sp.csr_matrix((a.vals, a.colidx, a.rowptr), shape=(a.m, a.n))
        t0 = time.perf_counter()
        n_it = max(3, iters)
        for _ in range(n_it):
            y = s @ x
        dt = (time.perf_counter() - t0) / n_it
        rows.append(_row(name, "ScipyCsr", "VECTOR_NONE", 1, a.nnz,
                         _rmse(y, golden), 0.0, dt * 1e3,
                         2 * a.nnz / dt / 1e9, 2 * a.nnz / dt / 1e9))
        print(rows[-1], file=out, flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"# ScipyCsr failed: {e}", file=out, flush=True)
    for label, build in (("JaxBcoo", _jax_bcoo), ("JaxCsr", _jax_csr)):
        try:
            import jax.numpy as jnp
            t0 = time.perf_counter()
            fn = build(a)
            predeal_ms = (time.perf_counter() - t0) * 1e3
            xj = jnp.asarray(x)
            y = np.asarray(fn(xj))
            r = time_spmv_chain(fn, xj, iters=iters, k=8, repeats=2)
            rows.append(_row(name, label, "VECTOR_NONE", 1, a.nnz,
                             _rmse(y, golden), predeal_ms,
                             r["inclusive"] * 1e3,
                             2 * a.nnz / r["inclusive"] / 1e9,
                             2 * a.nnz / r["marginal"] / 1e9))
            print(rows[-1], file=out, flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"# {label} failed: {e}", file=out, flush=True)
    return rows


def _jax_bcoo(a: CsrMatrix):
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    rows = np.repeat(np.arange(a.m, dtype=np.int32), a.row_lengths)
    bcoo = jsparse.BCOO((jnp.asarray(a.vals), jnp.asarray(
        np.stack([rows, a.colidx], axis=1))), shape=(a.m, a.n))
    return lambda x: bcoo @ x


def _jax_csr(a: CsrMatrix):
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    csr = jsparse.CSR((jnp.asarray(a.vals), jnp.asarray(a.colidx),
                       jnp.asarray(a.rowptr)), shape=(a.m, a.n))
    return lambda x: csr @ x


_DEFAULT_METHODS = [Method.SERIAL, Method.PARALLEL, Method.BALANCED,
                    Method.BALANCED2, Method.BALANCED_YID,
                    Method.SELL_C_SIGMA, Method.CSR5, Method.DIA,
                    Method.BCSR, Method.AUTO]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrices", nargs="+",
                   help="builtin:<name> or MatrixMarket paths")
    p.add_argument("--methods", default="AUTO",
                   help="comma list of Method names, or 'all'")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--external", action="store_true",
                   help="also run ScipyCsr/JaxBcoo/JaxCsr baselines")
    p.add_argument("--split-predeal", action="store_true",
                   help="append pack_ms,transfer_ms columns (predeal "
                        "split; blocks per-transfer)")
    p.add_argument("--out", default=None,
                   help="also append CSV rows to this file")
    args = p.parse_args(argv)

    if args.dtype == "bfloat16":
        import jax.numpy as jnp
        dtype = jnp.bfloat16
    else:
        dtype = np.dtype(args.dtype)
    if args.methods == "all":
        methods = list(_DEFAULT_METHODS)
    else:
        methods = [Method[m.strip().upper()]
                   for m in args.methods.split(",")]

    from ..utils import enable_compile_cache
    enable_compile_cache()
    import os
    header = CSV_HEADER + (",pack_ms,transfer_ms" if args.split_predeal
                           else "")
    print(header, flush=True)
    if args.out and not os.path.exists(args.out):
        with open(args.out, "w") as f:
            f.write(header + "\n")
    for spec in args.matrices:
        name, a = load_any(spec, dtype=dtype)
        rows = bench_matrix(name, a, methods, iters=args.iters,
                            repeats=args.repeats, external=args.external,
                            split_predeal=args.split_predeal)
        if args.out:
            # append per matrix so a crash mid-sweep loses nothing
            with open(args.out, "a") as f:
                for row in rows:
                    f.write(row + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
