"""Distributed AUTO: one-call mesh handle picks the plan family.

The reference's NUMA sample (numa.c:268-439) makes the user hand-pick
both the partitioning and x placement; build_dist_auto extends the
single-device inspector's DIA gate across the mesh and falls back to the
exact-nnz scan.  Runs on the 8-device virtual CPU mesh.
"""

import numpy as np
import pytest

from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.parallel import build_dist_auto, make_mesh_1d
from spmv_tpu.types import CsrMatrix


def _check(a, plan, rtol=2e-5, atol=1e-6):
    x = generate.make_x(a.n, a.dtype, kind="normal", seed=11)
    y = np.asarray(plan(x))
    ref = spmv_golden(a.astype(np.float64), x.astype(np.float64))
    np.testing.assert_allclose(np.asarray(y, dtype=np.float64), ref,
                               rtol=rtol, atol=atol)


def test_dist_auto_banded_routes_dia():
    a = generate.banded(6000, 6000, 3, dtype=np.float32, seed=1)
    plan = build_dist_auto(a, make_mesh_1d(8))
    assert plan.kind == "dia", plan.kind
    # banded ⇒ bounded column spread ⇒ the halo ring is the auto pick
    assert plan.x_mode == "halo", plan.x_mode
    _check(a, plan)


def test_dist_auto_clustered_routes_scan():
    a = generate.clustered(4000, 4000, 10, spread=300, dtype=np.float64,
                           seed=2, exact=False)
    plan = build_dist_auto(a, make_mesh_1d(4))
    assert plan.kind == "scan", plan.kind
    _check(a, plan)


def test_dist_auto_f64_uniform():
    a32 = generate.random_uniform(5000, 5000, 8, dtype=np.float32, seed=5)
    rng = np.random.default_rng(6)
    a = CsrMatrix(a32.m, a32.n, a32.rowptr, a32.colidx,
                  rng.standard_normal(a32.nnz))
    plan = build_dist_auto(a, make_mesh_1d(4))
    assert plan.kind == "scan", plan.kind
    _check(a, plan, rtol=1e-10, atol=1e-12)


def test_dist_auto_ultra_sparse_routes_scan():
    # ~1.5 nnz per 10 rows over random columns: no diagonal structure
    rng = np.random.default_rng(7)
    m = 1_000_000
    rows = np.sort(rng.integers(0, m, 150_000))
    cols = rng.integers(0, m, 150_000)
    a = CsrMatrix.from_coo(m, m, rows, cols,
                           rng.standard_normal(150_000).astype(np.float32))
    plan = build_dist_auto(a, make_mesh_1d(4))
    assert plan.kind == "scan", plan.kind
    # the scan's f32 global cumsum carries ~eps·sqrt(nnz) absolute error
    _check(a, plan, atol=2e-4)


def test_dist_auto_large_n_routes_scan_allgather():
    # n past 1M columns: x is sharded and all-gathered inside the shard
    a = generate.random_uniform(30_000, 2_500_000, 64, dtype=np.float64,
                                seed=20)
    plan = build_dist_auto(a, make_mesh_1d(8))
    assert (plan.kind, plan.x_mode) == ("scan", "allgather")
    _check(a, plan)


def test_dist_auto_webbase_routes_scan():
    a = generate.webbase_like(60_000, 60_000, 190_000, dtype=np.float64,
                              seed=21)
    plan = build_dist_auto(a, make_mesh_1d(4))
    assert plan.kind == "scan", plan.kind
    _check(a, plan)


@pytest.mark.parametrize("family", ["uniform", "powerlaw", "clustered"])
def test_dist_auto_8dev_picks_only_dia_or_scan(family):
    """On the 8-device virtual mesh every non-banded family lands on the
    scan and matches the oracle (f64, so the check sees the plan, not the
    f32 prefix scan's rounding)."""
    a = {
        "uniform": lambda: generate.random_uniform(
            6000, 6000, 8, seed=3, exact=False),
        "powerlaw": lambda: generate.power_law(
            20_000, 20_000, 16 * 20_000, seed=4, exact=False),
        "clustered": lambda: generate.clustered(
            8000, 8000, 12, spread=400, seed=8, exact=False),
    }[family]()
    plan = build_dist_auto(a, make_mesh_1d(8))
    assert plan.kind in ("dia", "scan"), plan.kind
    assert plan.kind == "scan", plan.kind
    _check(a, plan)


def test_dist_auto_halo_survives_stragglers():
    # 0.1% long-range nonzeros must NOT flip an otherwise banded matrix to allgather — the quantile gate
    # keeps halo and routes the stragglers through the plan-level rest
    # stream against the full x
    a = generate.banded(6000, 6000, 3, dtype=np.float32, seed=9)
    rng = np.random.default_rng(10)
    k = a.nnz // 1000                      # ~0.1% long-range entries
    rows = rng.integers(0, 3000, k)
    # spread ≥ 3000 ≫ mr=750 (clamped to the column range)
    cols = np.minimum(rows + 3000 + rng.integers(0, 2500, k), a.n - 1)
    lens = a.row_lengths.astype(np.int64)
    r_all = np.concatenate([np.repeat(np.arange(a.m), lens), rows])
    c_all = np.concatenate([np.asarray(a.colidx, dtype=np.int64), cols])
    v_all = np.concatenate([np.asarray(a.vals),
                            rng.standard_normal(k).astype(np.float32)])
    a2 = CsrMatrix.from_coo(a.m, a.n, r_all, c_all, v_all)
    plan = build_dist_auto(a2, make_mesh_1d(8))
    assert plan.x_mode.startswith("halo"), plan.x_mode
    assert plan.rest is not None and len(plan.rest[0]) == k
    _check(a2, plan)


@pytest.mark.parametrize("forced", ["replicated", "allgather"])
def test_dist_auto_forced_x_mode(forced):
    a = generate.random_uniform(4000, 4000, 8, dtype=np.float64, seed=8)
    plan = build_dist_auto(a, make_mesh_1d(4), x_mode=forced)
    assert plan.x_mode == forced
    _check(a, plan)
