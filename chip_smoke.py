#!/usr/bin/env python
"""On-card smoke test: the main SpMV paths at benchmark size on a GPU.

    python chip_smoke.py                # one GPU: phases auto, methods, cg
    python chip_smoke.py --four-cards   # four GPUs: the mesh phase only

Phases (one card):

1. ``auto``: the nine bench families (``spmv_tpu.bench.suite.FAMILIES``)
   at their full sizes, each built with ``create_handle(a, Method.AUTO)``,
   run a few times and compared with ``spmv_golden`` (f64 on the host).
2. ``methods``: every Method explicitly (0-6 on uniform100k f32/f64 and
   banded1m, DIA on banded1m, BCSR on a block-dense matrix), plus one
   exact-arithmetic case per method (dyadic values, x = 1, f64, bit-exact).
3. ``cg``: ``solvers.cg`` through a handle on a 1M-row SPD banded matrix;
   the residual is checked on the host.

``--four-cards`` runs only the mesh phase on ``make_mesh_1d(4)``:
``build_dist_plan`` (replicated, allgather, halo), ``build_dist_dia_plan``
(replicated, halo) and ``build_dist_auto`` (banded, uniform, powerlaw),
each against ``spmv_golden``.

Tolerances are the CPU tests' bounds: ``max|y-g| <= 1e-4*max(|g|,1)`` in
f32 and ``1e-10*max(|g|,1)`` in f64 (a TF32 contraction would miss the f32
bound).  The run exits non-zero and prints no ``ok`` line when the first
device is not a GPU, when any phase raises, or when any result is out of
tolerance.  Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Everything runs in this one process: a JAX process reserves most of a
card's memory, so no child touches the GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

F32_TOL = 1e-4
F64_TOL = 1e-10


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, kind and count of the JAX devices, plus the nvidia-smi
    line.  Raises unless the first device is a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"a GPU is required; JAX's first device is "
                           f"{devs[0].platform!r} ({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi_line()}


class Checker:
    """Collects every comparison; the run fails if any one fails."""

    def __init__(self):
        self.worst = {}        # phase -> (ratio, label)
        self.failures = []

    def close(self, phase, label, y, g, tol):
        y = np.asarray(y, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        bad = y.shape != g.shape or not np.all(np.isfinite(y))
        scale = max(float(np.max(np.abs(g), initial=0.0)), 1.0)
        err = float("inf") if bad else float(
            np.max(np.abs(y - g), initial=0.0))
        ratio = err / (tol * scale)
        ok = ratio <= 1.0
        print(f"  {label}: max|y-g| {err:.3e} <= tol {tol:g}*{scale:.4g} "
              f"({ratio:.3g} of tol) {'ok' if ok else 'FAIL'}", flush=True)
        self._note(phase, label, ratio, ok)

    def exact(self, phase, label, y, g):
        y = np.asarray(y, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        nbad = int(np.count_nonzero(y != g)) if y.shape == g.shape \
            else -1
        ok = nbad == 0
        print(f"  {label}: bit-exact {'ok' if ok else 'FAIL'} "
              f"({nbad} rows differ)", flush=True)
        self._note(phase, label, 0.0 if ok else float("inf"), ok)

    def _note(self, phase, label, ratio, ok):
        if ratio >= self.worst.get(phase, (-1.0, ""))[0]:
            self.worst[phase] = (ratio, label)
        if not ok:
            self.failures.append(f"{phase}/{label}")


def _peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _with_dtype(a, dtype, seed=7):
    """``a``'s structure with random normal values in ``dtype``."""
    from spmv_tpu.types import CsrMatrix
    vals = np.random.default_rng(seed).standard_normal(a.nnz).astype(dtype)
    return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, vals)


def _run_handle(h, x, repeats=3):
    """First call (compile + run) seconds, steady seconds, last y."""
    import jax
    t0 = time.perf_counter()
    y = jax.block_until_ready(h(x))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(repeats):
        y = jax.block_until_ready(h(x))
    return first, (time.perf_counter() - t0) / repeats, y


def phase_auto(chk: Checker) -> float:
    """AUTO on the nine bench families at their full sizes."""
    from spmv_tpu import Method, create_handle
    from spmv_tpu.bench.suite import FAMILIES, family
    from spmv_tpu.oracle import spmv_golden
    compile_s = 0.0
    for name in FAMILIES:
        a = family(name)
        dt = np.asarray(a.vals).dtype
        x = np.random.default_rng(0).standard_normal(a.n).astype(dt)
        t0 = time.perf_counter()
        h = create_handle(a, method=Method.AUTO)
        build = time.perf_counter() - t0
        first, steady, y = _run_handle(h, x)
        compile_s += max(first - steady, 0.0)
        print(f"  {name}: nnz {a.nnz} {h.method_name} build {build:.2f} s "
              f"first call {first:.2f} s steady {steady * 1e3:.3f} ms",
              flush=True)
        g = spmv_golden(a, x.astype(np.float64))
        chk.close("auto", f"{name} {h.method_name}", y, g,
                  F64_TOL if dt == np.float64 else F32_TOL)
        del h, a, y
    return compile_s


def phase_methods(chk: Checker) -> float:
    """Every method explicitly, random values and the exact case."""
    from spmv_tpu import Method, create_handle
    from spmv_tpu.io import generate
    from spmv_tpu.oracle import spmv_golden
    general = [Method.SERIAL, Method.PARALLEL, Method.BALANCED,
               Method.BALANCED2, Method.BALANCED_YID, Method.SELL_C_SIGMA,
               Method.CSR5]
    uni = generate.random_uniform(100_000, 100_000, 40, dtype=np.float32,
                                  seed=42)
    band = generate.banded(1_000_000, 1_000_000, 4, dtype=np.float32,
                           seed=7, exact=False)
    blocky = generate.block_random(256, 256, blocks_per_row=4, fill=0.4,
                                   dtype=np.float32, seed=5)
    cases = [("uniform100k", _with_dtype(uni, np.float32), general),
             ("uniform100k_f64", _with_dtype(uni, np.float64), general),
             ("banded1m", band, general + [Method.DIA]),
             ("banded1m_f64", _with_dtype(band, np.float64), [Method.DIA]),
             ("blocky32k", _with_dtype(blocky, np.float32), [Method.BCSR]),
             ("blocky32k_f64", _with_dtype(blocky, np.float64),
              [Method.BCSR])]
    # exact arithmetic: dyadic values, x = 1, f64 — any summation order
    # gives the oracle's bits unless a product loses precision
    exact = [("uniform100k", uni.astype(np.float64), general),
             ("banded1m", generate.banded(1_000_000, 1_000_000, 4,
                                          dtype=np.float64, seed=7),
              [Method.DIA]),
             ("blocky32k", blocky.astype(np.float64), [Method.BCSR])]
    compile_s = 0.0
    for name, a, methods in cases:
        dt = np.asarray(a.vals).dtype
        x = np.random.default_rng(1).standard_normal(a.n).astype(dt)
        g = spmv_golden(a, x.astype(np.float64))
        for method in methods:
            h = create_handle(a, method=method)
            first, steady, y = _run_handle(h, x, repeats=2)
            compile_s += max(first - steady, 0.0)
            chk.close("methods", f"{name} {method.name}->{h.method_name} "
                      f"({steady * 1e3:.3f} ms)", y, g,
                      F64_TOL if dt == np.float64 else F32_TOL)
            del h
    for name, a, methods in exact:
        x = np.ones(a.n, np.float64)
        g = spmv_golden(a, x)
        for method in methods:
            h = create_handle(a, method=method)
            first, steady, y = _run_handle(h, x, repeats=1)
            compile_s += max(first - steady, 0.0)
            chk.exact("methods", f"exact {name} {method.name}->"
                      f"{h.method_name}", y, g)
            del h
    return compile_s


def _spd_banded(grid: int):
    """5-point 2-D Laplacian on a grid×grid mesh plus the identity: SPD,
    banded (offsets 0, ±1, ±grid), condition number about 9."""
    from spmv_tpu.types import CsrMatrix
    m = grid * grid
    i = np.arange(m, dtype=np.int64)
    rows, cols, vals = [i], [i], [np.full(m, 5.0)]
    for off, ok in ((1, (i % grid) != grid - 1), (grid, i + grid < m)):
        r = i[ok]
        rows += [r, r + off]
        cols += [r + off, r]
        vals += [np.full(r.size, -1.0)] * 2
    return CsrMatrix.from_coo(m, m, np.concatenate(rows),
                              np.concatenate(cols), np.concatenate(vals))


def phase_cg(chk: Checker) -> float:
    """CG through a handle on a 1M-row SPD banded matrix."""
    from spmv_tpu import Method, create_handle
    from spmv_tpu.oracle import spmv_golden
    from spmv_tpu.solvers import cg
    a = _spd_banded(1024)
    h = create_handle(a, method=Method.AUTO)
    b = np.random.default_rng(3).standard_normal(a.n)
    # the solver stops at 1e-9 relative; the host check allows 1e-8
    t0 = time.perf_counter()
    x, res, iters = cg(h, b, tol=1e-9 * float(np.linalg.norm(b)),
                       maxiter=500)
    wall = time.perf_counter() - t0
    r = b - spmv_golden(a, np.asarray(x))
    rel = float(np.linalg.norm(r) / np.linalg.norm(b))
    print(f"  cg: {a.m} rows {a.nnz} nnz {h.method_name}, {iters} "
          f"iterations in {wall:.2f} s, device residual {res:.3e}, host "
          f"relative residual {rel:.3e}", flush=True)
    chk.close("cg", "host residual ||b-Ax||/||b||", [rel], [0.0], 1e-8)
    return 0.0


def phase_mesh(chk: Checker) -> float:
    """The sharded plans on four cards against the host oracle."""
    import jax
    from spmv_tpu.bench.suite import family
    from spmv_tpu.io import generate
    from spmv_tpu.oracle import spmv_golden
    from spmv_tpu.parallel import (build_dist_auto, build_dist_dia_plan,
                                   build_dist_plan, make_mesh_1d)
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    mesh = make_mesh_1d(4)
    band = generate.banded(1_500_000, 1_500_000, 3, dtype=np.float64,
                           seed=15, exact=False)            # 10.5M nnz
    xb = np.random.default_rng(16).standard_normal(band.n)
    gb = spmv_golden(band, xb)
    compile_s = 0.0

    def run(label, plan, x, g, tol):
        nonlocal compile_s
        t0 = time.perf_counter()
        y = jax.block_until_ready(plan(x))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = jax.block_until_ready(plan(x))
        steady = time.perf_counter() - t0
        compile_s += max(first - steady, 0.0)
        chk.close("mesh", f"{label} ({steady * 1e3:.3f} ms)", y, g, tol)

    for mode in ("replicated", "allgather", "halo"):
        run(f"dist_plan {mode} banded {band.nnz} nnz",
            build_dist_plan(band, mesh, x_mode=mode), xb, gb, F64_TOL)
    for mode in ("replicated", "halo"):
        run(f"dist_dia {mode} banded {band.nnz} nnz",
            build_dist_dia_plan(band, mesh, x_mode=mode), xb, gb, F64_TOL)
    for name in ("banded4m", "uniform100k", "powerlaw100k"):
        a = family(name)
        x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
        plan = build_dist_auto(a, mesh)
        run(f"dist_auto {name} {plan.kind}/{plan.x_mode}", plan, x,
            spmv_golden(a, x.astype(np.float64)), F32_TOL)
        del plan
    return compile_s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the mesh phase, on four GPUs")
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    device = device_record()
    print(f"nvidia-smi: {device['nvidia_smi']}", flush=True)
    print(f"jax: platform {device['platform']} kind {device['kind']} "
          f"count {device['count']}", flush=True)
    from spmv_tpu.utils import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    phases = ([("mesh", phase_mesh)] if args.four_cards else
              [("auto", phase_auto), ("methods", phase_methods),
               ("cg", phase_cg)])
    chk = Checker()
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            compile_s = fn(chk)
        except Exception:  # noqa: BLE001 — reported; the run exits 1
            traceback.print_exc()
            chk.failures.append(f"{name} raised")
            compile_s = float("nan")
        worst = chk.worst.get(name, (float("nan"), "-"))
        print(f"phase {name}: wall {time.perf_counter() - t0:.2f} s, "
              f"compile (first call minus steady) {compile_s:.2f} s, "
              f"peak_bytes_in_use {_peak_bytes()}, largest error "
              f"{worst[0]:.3g} of tol ({worst[1]})", flush=True)
    if chk.failures:
        print(f"FAILED: {chk.failures}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
