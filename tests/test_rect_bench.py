"""Rect matrices through the bench/tune paths (the reference harness
benches any matrix)."""

import io

import numpy as np

from spmv_tpu.io import generate
from spmv_tpu.inspector import tune
from spmv_tpu.types import Method


def test_suite_benches_rect_matrix():
    from spmv_tpu.bench.suite import bench_matrix
    a = generate.banded(256, 400, 3, dtype=np.float64, seed=1)
    out = io.StringIO()
    rows = bench_matrix("rect", a, [Method.SERIAL, Method.BALANCED],
                        iters=3, repeats=1, out=out)
    assert len(rows) == 2
    for row in rows:
        fields = row.split(",")
        assert float(fields[5]) < 1e-8          # rmse vs golden
        assert float(fields[8]) > 0             # GFLOPs_avg populated


def test_tune_rect():
    a = generate.random_uniform(300, 180, 5, dtype=np.float64, seed=2)
    h, results = tune(a, methods=[Method.SERIAL, Method.BALANCED_YID],
                      iters=3, repeats=1)
    assert h.m == 300 and h.n == 180
    assert any(np.isfinite(v) for v in results.values())


def test_chain_timing_rect_protocol():
    import jax.numpy as jnp
    from spmv_tpu.bench.timing import time_spmv_chain
    from spmv_tpu import create_handle, spmv, Method as M
    a = generate.banded(200, 300, 2, dtype=np.float64, seed=3)
    h = create_handle(a, method=M.SERIAL)
    x = jnp.asarray(generate.make_x(a.n, np.float64, kind="normal", seed=4))
    r = time_spmv_chain(h._bound, x, iters=3, k=4, repeats=1)
    assert r["inclusive"] > 0 and r["marginal"] > 0
