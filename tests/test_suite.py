"""Bench-suite harness tests (CPU, small matrices)."""

import io as _io

import numpy as np
import pytest

from spmv_tpu.bench import suite
from spmv_tpu.types import Method


def test_bench_matrix_csv_schema():
    from spmv_tpu.io import generate
    a = generate.banded(200, 200, 2, dtype=np.float32)
    buf = _io.StringIO()
    rows = suite.bench_matrix("t", a, [Method.SERIAL, Method.DIA],
                              iters=2, repeats=1, out=buf)
    assert len(rows) == 2
    for row in rows:
        fields = row.split(",")
        assert len(fields) == 10                       # reference schema
        assert fields[0] == "t"
        assert float(fields[5]) < 1e-5                 # rmse
        assert int(fields[4]) == a.nnz


def test_load_any_builtin():
    name, a = suite.load_any("builtin:uniform10k")
    assert name == "uniform10k" and a.m == 10_000


def test_bench_matrix_accepts_rect():
    """Round-2: rect matrices time via the scalar-feedback chain
    (timing.time_spmv_chain) — no square-only restriction left."""
    from spmv_tpu.io import generate
    a = generate.random_uniform(50, 70, 4)
    rows = suite.bench_matrix("r", a, [Method.SERIAL], iters=1, repeats=1,
                              out=__import__("io").StringIO())
    assert len(rows) == 1


def test_bench_matrix_external_rows():
    """The external baselines, the vendor CSR among them, agree with the
    oracle and use the reference schema."""
    from spmv_tpu.io import generate
    a = generate.random_uniform(300, 300, 6, dtype=np.float32, seed=3)
    buf = _io.StringIO()
    rows = suite.bench_matrix("e", a, [Method.SERIAL], iters=2, repeats=1,
                              external=True, out=buf)
    assert "failed" not in buf.getvalue()
    methods = [r.split(",")[1] for r in rows]
    assert methods == ["Method_Serial", "ScipyCsr", "JaxBcoo", "JaxCsr"]
    for row in rows:
        fields = row.split(",")
        assert len(fields) == 10
        assert float(fields[5]) < 1e-5 and float(fields[7]) > 0


def test_family_f64_keeps_structure(monkeypatch):
    """A ``_f64`` family is its f32 family's structure with f64 values."""
    from spmv_tpu.io import generate
    monkeypatch.setitem(suite.BUILTIN_MATRICES, "uniform100k",
                        lambda dtype: generate.random_uniform(
                            500, 500, 5, dtype=dtype, seed=42))
    a32, a64 = suite.family("uniform100k"), suite.family("uniform100k_f64")
    assert a32.vals.dtype == np.float32 and a64.vals.dtype == np.float64
    np.testing.assert_array_equal(a32.rowptr, a64.rowptr)
    np.testing.assert_array_equal(a32.colidx, a64.colidx)
    assert not np.array_equal(a64.vals, a32.vals.astype(np.float64))


def test_family_names():
    assert len(suite.FAMILIES) == 9
    for name in suite.FAMILIES:
        assert name.removesuffix("_f64") in suite.BUILTIN_MATRICES
    with pytest.raises(ValueError, match="unknown family"):
        suite.family("banded100k_f64")
