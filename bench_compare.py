#!/usr/bin/env python
"""Plans against the vendor library on one GPU.

    python bench_compare.py --out bench_out/compare.json

Sections, each printed as it finishes and written to ``--out``:

* ``copy``: a large on-device copy, the bandwidth ceiling a plan is set
  against (besides the 3.35 TB/s HBM peak of the H100 SXM data sheet);
* ``families``: for each bench family (``spmv_tpu.bench.suite.FAMILIES``),
  the suite's rows for the AUTO plan and its external baselines: ``JaxCsr``
  (``jax.experimental.sparse.CSR @ x``, which lowers to cuSPARSE's SpMV on
  a GPU), ``JaxBcoo`` (XLA's own lowering) and ``ScipyCsr`` (host).  Each
  device row carries bytes over time under the plan's own traffic model
  (``utils/perfmodel.bytes_moved``): the DIA model at the diagonals' stored
  width for a DIA plan, the CSR model for everything else;
* ``trace``: one profiler trace each of uniform100k's AUTO plan and of
  ``JaxCsr``, reduced to device time per kernel name, which shows whether
  a cuSPARSE kernel ran;
* ``methods``: the suite's rows for every Method on uniform100k and
  powerlaw100k;
* ``barriers``: SERIAL and SELL with and without their
  ``optimization_barrier``.

Every time is the chained protocol of ``spmv_tpu/bench/timing.py``
(``inclusive``: T(k)/k, ending in ``block_until_ready``).  The run refuses
a non-GPU device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import io
import json
import os
import sys
import time

import numpy as np

#: HBM peak of one H100 SXM (NVIDIA data sheet), bytes/s
H100_HBM_BYTES_S = 3.35e12

#: fields of a suite CSV row (``spmv_tpu.bench.suite.CSV_HEADER``)
_METHOD, _AVG_MS = 1, 7


def copy_ceiling(nbytes=1 << 30) -> dict:
    """Bytes/s of a read+write stream over ``nbytes`` (one array each)."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones(nbytes // 4, jnp.float32)
    f = jax.jit(lambda v: v * 1.0000001)
    jax.block_until_ready(f(x))
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        x = f(x)
    jax.block_until_ready(x)
    dt = (time.perf_counter() - t0) / reps
    return {"bytes": 2 * nbytes, "seconds": dt,
            "bytes_per_s": 2 * nbytes / dt}


def model_bytes(a, h=None) -> tuple:
    """(model name, bytes per SpMV) under the traffic model of handle
    ``h``'s plan; the CSR model without a handle."""
    from spmv_tpu.types import Method
    from spmv_tpu.utils.perfmodel import bytes_moved
    vb = np.dtype(a.dtype).itemsize
    if h is not None and h.method == Method.DIA:
        data = h.plan["data"]
        return "dia", bytes_moved(
            a.m, a.n, a.nnz, val_bytes=vb, fmt="dia",
            pad_ratio=data.size / max(a.nnz, 1),
            stored_val_bytes=np.dtype(data.dtype).itemsize)
    return "csr", bytes_moved(a.m, a.n, a.nnz, val_bytes=vb)


def _suite_rows(name, a, methods, external=False) -> list:
    from spmv_tpu.bench.suite import bench_matrix
    buf = io.StringIO()
    rows = bench_matrix(name, a, methods, external=external, out=buf)
    failed = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("#")]
    if failed:
        raise RuntimeError(f"{name}: {failed}")
    return [r.split(",") for r in rows]


def families() -> dict:
    from spmv_tpu.bench.suite import FAMILIES, family
    from spmv_tpu.handle import create_handle
    from spmv_tpu.types import Method
    out = {}
    for name in FAMILIES:
        a = family(name)
        h = create_handle(a, method=Method.AUTO)
        model, b = model_bytes(a, h)
        rec = {"nnz": a.nnz, "m": a.m, "method": h.method_name,
               "dtype": str(np.dtype(a.dtype)), "bytes_model": model,
               "model_bytes": b}
        if h.method == Method.DIA:
            rec["stored_dtype"] = str(h.plan["data"].dtype)
        del h
        for f in _suite_rows(name, a, [Method.AUTO], external=True):
            label = "plan" if f[_METHOD].startswith("Method_") \
                else f[_METHOD]
            t = float(f[_AVG_MS]) / 1e3
            rec[label] = {"ms": t * 1e3, "gflops": 2 * a.nnz / t / 1e9}
            if label in ("plan", "JaxCsr", "JaxBcoo"):
                # the vendor rows read CSR/COO, whatever the plan stores
                vb = b if label == "plan" else model_bytes(a)[1]
                rec[label]["bytes_per_s"] = vb / t
                rec[label]["share_of_hbm_peak"] = vb / t / H100_HBM_BYTES_S
        print(f"# families {name}: {json.dumps(rec)}", flush=True)
        out[name] = rec
        del a
    return out


def trace(trace_dir, name="uniform100k", calls=5) -> dict:
    """Device kernel names and total device time of the AUTO plan and of
    ``JaxCsr`` on one family, from one profiler trace each."""
    import jax
    import jax.numpy as jnp
    from spmv_tpu.bench.suite import _jax_csr, family
    from spmv_tpu.handle import create_handle
    from spmv_tpu.types import Method
    a = family(name)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(a.n)
                    .astype(a.dtype))
    res = {}
    for label, fn in (("plan", create_handle(a, Method.AUTO)._bound),
                      ("JaxCsr", _jax_csr(a))):
        jax.block_until_ready(fn(x))
        d = os.path.join(trace_dir, label)
        with jax.profiler.trace(d):
            for _ in range(calls):
                y = fn(x)
            jax.block_until_ready(y)
        res[label] = dict(reduce_trace(d), calls=calls)
    return {name: res}


def reduce_trace(d) -> dict:
    """Sum device event durations by name over the GPU planes of the newest
    ``.xplane.pb`` under ``d``."""
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise RuntimeError(f"no .xplane.pb written under {d}")
    pd = ProfileData.from_file(paths[-1])
    per = collections.Counter()
    for plane in pd.planes:
        if "gpu" not in plane.name.lower():
            continue
        for line in plane.lines:
            for ev in line.events:
                per[ev.name] += ev.duration_ns
    return {"kernels_ns": {k: int(v) for k, v in per.most_common(12)},
            "cusparse_seen": any("cusparse" in k.lower()
                                 or "csrmv" in k.lower()
                                 or "spmv" in k.lower() for k in per)}


def methods() -> dict:
    from spmv_tpu.bench.suite import family
    from spmv_tpu.types import METHOD_NAMES, Method
    out = {}
    for name in ("uniform100k", "powerlaw100k"):
        a = family(name)
        rec = {}
        for method in (Method.SERIAL, Method.PARALLEL, Method.BALANCED,
                       Method.BALANCED2, Method.BALANCED_YID,
                       Method.SELL_C_SIGMA, Method.CSR5, Method.AUTO):
            (f,) = _suite_rows(name, a, [method])
            rec[METHOD_NAMES[method]] = {"resolved": f[_METHOD],
                                         "ms": float(f[_AVG_MS])}
        print(f"# methods {name}: {json.dumps(rec)}", flush=True)
        out[name] = rec
    return out


@contextlib.contextmanager
def _no_barriers():
    """Trace with ``optimization_barrier`` as the identity."""
    import jax
    saved = jax.lax.optimization_barrier
    jax.lax.optimization_barrier = lambda x: x
    try:
        yield
    finally:
        jax.lax.optimization_barrier = saved


def barriers() -> dict:
    """SERIAL and SELL timed on, off, off, on.  The timing protocol traces
    a fresh step each call, so the patched barrier takes effect."""
    import jax.numpy as jnp
    from spmv_tpu.bench.suite import family
    from spmv_tpu.bench.timing import time_spmv_chain
    from spmv_tpu.handle import create_handle
    from spmv_tpu.ops import xla_csr
    from spmv_tpu.types import Method
    out = {}
    for label, name, method in (
            ("serial_uniform100k", "uniform100k", Method.SERIAL),
            ("sell_clustered200k", "clustered200k", Method.SELL_C_SIGMA)):
        a = family(name)
        p = create_handle(a, method=method).plan
        if method == Method.SERIAL:
            fn = lambda x, p=p, m=a.m: xla_csr.segment_sum_spmv(
                p["rows"], p["colidx"], p["vals"], x, m=m)
        else:
            fn = lambda x, p=p: xla_csr.sell_spmv(
                p["cols"], p["vals"], p["chunk_ids"], p["inv_pos"], x,
                nslices=p["nslices"], identity_order=p["identity_order"])
        x = jnp.asarray(np.random.default_rng(0).standard_normal(a.n)
                        .astype(np.float32))
        rec = {"nnz": a.nnz}
        for mode in ("on", "off", "off", "on"):
            with _no_barriers() if mode == "off" else contextlib.nullcontext():
                t = time_spmv_chain(fn, x, iters=10, k=8,
                                    repeats=3)["inclusive"]
            rec.setdefault(mode + "_ms", []).append(t * 1e3)
        print(f"# barriers {label}: {json.dumps(rec)}", flush=True)
        out[label] = rec
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="bench_out/compare.json")
    p.add_argument("--trace-dir", default="bench_out/trace")
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    from chip_smoke import device_record
    from spmv_tpu.utils import enable_compile_cache
    rec = {"device": device_record()}       # raises unless a GPU is present
    enable_compile_cache()
    print(f"# device: {json.dumps(rec['device'])}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for sec, fn in (("copy", copy_ceiling), ("families", families),
                    ("trace", lambda: trace(args.trace_dir)),
                    ("methods", methods), ("barriers", barriers)):
        t0 = time.perf_counter()
        rec[sec] = fn()
        print(f"# {sec} done in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(rec[sec])[:2000]}", flush=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
