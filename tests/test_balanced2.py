"""Balanced2 is a distinct algorithm with the reference's demotion rule
(parallel_balanced2_spmv.c:55-209, :87-90)."""

import numpy as np

from spmv_tpu import create_handle, spmv, Method
from spmv_tpu.formats.partition import build_balanced2_plan
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.types import CsrMatrix


def _megarow_matrix(m=300, n=50_000, mega_nnz=20_000, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        np.zeros(mega_nnz, dtype=np.int64),                # one mega-row
        rng.integers(1, m, size=2000),
    ])
    cols = rng.integers(0, n, size=rows.size)
    vals = generate.exact_values(rng, rows.size)
    return CsrMatrix.from_coo(m, n, rows, cols, vals)


def test_megarow_builds_distinct_plan():
    a = _megarow_matrix()
    h = create_handle(a, method=Method.BALANCED2)
    assert h.method == Method.BALANCED2
    assert "sub_start" in h.plan and h.plan["n_mega_rows"] >= 1
    assert h.plan["m_virtual"] > a.m
    x = generate.make_x(a.n, np.float64, kind="normal", seed=1)
    np.testing.assert_allclose(np.asarray(spmv(h, x)), spmv_golden(a, x),
                               rtol=1e-9)


def test_demotes_to_balanced_without_megarows():
    a = generate.banded(3000, 3000, 3, dtype=np.float64, seed=2)
    h = create_handle(a, method=Method.BALANCED2)
    assert h.requested_method == Method.BALANCED2
    assert h.method == Method.BALANCED          # demoted, and visibly so
    hb = create_handle(a, method=Method.BALANCED)
    assert set(h.plan) == set(hb.plan)
    x = generate.make_x(a.n, np.float64, kind="normal", seed=3)
    np.testing.assert_allclose(np.asarray(spmv(h, x)), spmv_golden(a, x),
                               rtol=1e-9)


def test_plans_differ_between_balanced_and_balanced2():
    """A test that can tell the two methods apart."""
    a = _megarow_matrix(seed=4)
    h2 = create_handle(a, method=Method.BALANCED2)
    hb = create_handle(a, method=Method.BALANCED)
    assert set(h2.plan) != set(hb.plan)
    x = generate.make_x(a.n, np.float64, kind="normal", seed=5)
    y2 = np.asarray(spmv(h2, x))
    yb = np.asarray(spmv(hb, x))
    g = spmv_golden(a, x)
    np.testing.assert_allclose(y2, g, rtol=1e-9)
    np.testing.assert_allclose(yb, g, rtol=1e-9)


def test_builder_demotion_rule_unit():
    a = generate.random_uniform(500, 500, 5, dtype=np.float64, seed=6)
    assert build_balanced2_plan(a, tile=1024) is None     # no mega-rows
    b2 = build_balanced2_plan(_megarow_matrix(), tile=1024)
    assert b2 is not None and b2.n_mega_rows == 1
    # virtual rows partition the nnz stream exactly
    assert b2.inner.row_start.shape[0] == b2.m_virtual


def test_empty_rows_and_tiny():
    a = generate.with_empty_rows(_megarow_matrix(seed=7), 0.3, seed=8)
    h = create_handle(a, method=Method.BALANCED2)
    x = generate.make_x(a.n, np.float64, kind="normal", seed=9)
    np.testing.assert_allclose(np.asarray(spmv(h, x)), spmv_golden(a, x),
                               rtol=1e-9)
