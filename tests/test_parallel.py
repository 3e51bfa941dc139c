"""Multi-device SpMV on the 8-device virtual CPU mesh (SURVEY.md §4)."""

import numpy as np
import pytest
import jax

from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.parallel import build_dist_plan, dist_spmv, make_mesh_1d


@pytest.mark.parametrize("x_mode", ["replicated", "allgather"])
@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_dist_matches_golden(matrices, x_mode, ndev):
    mesh = make_mesh_1d(ndev)
    for name, a in matrices.items():
        x = generate.make_x(a.n, a.dtype, kind="normal", seed=11)
        plan = build_dist_plan(a, mesh, tile=256, x_mode=x_mode)
        y = np.asarray(dist_spmv(plan, x))
        ref = spmv_golden(a, x)
        np.testing.assert_allclose(y, ref, rtol=1e-10, atol=1e-12,
                                   err_msg=f"{name} ndev={ndev} {x_mode}")


def test_dist_nnz_balance():
    a = generate.power_law(4000, 4000, 120_000, seed=3)
    mesh = make_mesh_1d(8)
    plan = build_dist_plan(a, mesh)
    s = plan.row_splitter
    rp = a.rowptr.astype(np.int64)
    shard_nnz = rp[s[1:]] - rp[s[:-1]]
    # every shard's nnz within one max-row-length of the ideal quantile
    ideal = a.nnz / 8
    max_row = int(a.row_lengths.max())
    assert shard_nnz.max() <= ideal + max_row + 1


def test_dist_f32():
    a = generate.random_uniform(700, 600, 8, seed=9).astype(np.float32)
    x = generate.make_x(a.n, np.float32, kind="normal", seed=1)
    plan = build_dist_plan(a, make_mesh_1d(8), tile=128, x_mode="allgather")
    y = np.asarray(dist_spmv(plan, x))
    ref = spmv_golden(a.astype(np.float64), x.astype(np.float64))
    np.testing.assert_allclose(y, ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("x_mode", ["replicated", "allgather", "halo"])
def test_dist_dia(matrices, x_mode):
    from spmv_tpu.parallel import build_dist_dia_plan, dist_dia_spmv
    for name in ("banded", "banded_rect"):
        a = matrices[name]
        if x_mode == "halo" and a.m != a.n:
            continue
        mesh = make_mesh_1d(8)
        plan = build_dist_dia_plan(a, mesh, x_mode=x_mode)
        x = generate.make_x(a.n, a.dtype, kind="normal", seed=4)
        y = np.asarray(dist_dia_spmv(plan, x))
        np.testing.assert_allclose(y, spmv_golden(a, x), rtol=1e-10,
                                   atol=1e-12, err_msg=f"{name} {x_mode}")


def test_dist_dia_halo_rejects():
    from spmv_tpu.parallel import build_dist_dia_plan
    import pytest as _pytest
    a = generate.banded(200, 350, 3)          # rectangular
    with _pytest.raises(ValueError):
        build_dist_dia_plan(a, make_mesh_1d(8), x_mode="halo")
    b = generate.banded(64, 64, 20)           # band wider than shard
    with _pytest.raises(ValueError):
        build_dist_dia_plan(b, make_mesh_1d(8), x_mode="halo")


@pytest.mark.parametrize("seed", range(12))
def test_dist_fuzz(seed):
    """Random structures × the general dist plan × random mesh sizes."""
    rng = np.random.default_rng(2000 + seed)
    m = int(rng.integers(2, 600))
    n = int(rng.integers(2, 600))
    nnz = int(rng.integers(0, min(m * n, 4000)))
    rows = rng.integers(0, m, size=nnz).astype(np.int32)
    cols = rng.integers(0, n, size=nnz).astype(np.int32)
    vals = rng.standard_normal(nnz)
    from spmv_tpu.types import CsrMatrix
    a = CsrMatrix.from_coo(m, n, rows, cols, vals)
    ndev = int(rng.choice([1, 2, 3, 5, 8]))
    x_mode = str(rng.choice(["replicated", "allgather"]))
    mesh = make_mesh_1d(ndev)
    plan = build_dist_plan(a, mesh, tile=128, x_mode=x_mode)
    x = rng.standard_normal(n)
    y = np.asarray(dist_spmv(plan, x))
    np.testing.assert_allclose(
        y, spmv_golden(a, x), rtol=1e-9, atol=1e-11,
        err_msg=f"seed={seed} m={m} n={n} nnz={a.nnz} ndev={ndev} {x_mode}")


@pytest.mark.parametrize("halo", [1, 2])
def test_dist_general_halo(halo):
    # clustered square matrix: columns within +-halo neighbor blocks
    spread = 60 if halo == 1 else 150
    a = generate.clustered(1024, 1024, 10, spread=spread, seed=12)
    mesh = make_mesh_1d(8)
    plan = build_dist_plan(a, mesh, tile=128, x_mode="halo",
                           halo_shards=halo)
    x = generate.make_x(a.n, a.dtype, kind="normal", seed=2)
    y = np.asarray(dist_spmv(plan, x))
    np.testing.assert_allclose(y, spmv_golden(a, x), rtol=1e-10, atol=1e-12)


def test_dist_general_halo_cyclic_wraps():
    # cyclic band: row 0 references the last columns and vice versa.  The
    # ppermute rings are circular, so the required depth is 1 via
    # wrap-around — a non-wrapping block distance would claim ndev-1 and
    # refuse the build.
    m = 1024
    base = generate.banded(m, m, 2, seed=4)
    rows = np.concatenate([np.repeat(np.arange(m, dtype=np.int64),
                                     base.row_lengths),
                           np.arange(3), m - 1 - np.arange(3)])
    cols = np.concatenate([base.colidx.astype(np.int64),
                           m - 1 - np.arange(3), np.arange(3)])
    vals = np.concatenate([base.vals, np.full(6, 0.5)])
    from spmv_tpu.types import CsrMatrix
    a = CsrMatrix.from_coo(m, m, rows, cols, vals)
    mesh = make_mesh_1d(8)
    plan = build_dist_plan(a, mesh, tile=128, x_mode="halo")
    assert plan._halo <= 2          # wraps, instead of needing depth 7
    x = generate.make_x(a.n, a.dtype, kind="normal", seed=2)
    y = np.asarray(dist_spmv(plan, x))
    np.testing.assert_allclose(y, spmv_golden(a, x), rtol=1e-10, atol=1e-12)


def test_dist_general_halo_rejects_scatter():
    a = generate.random_uniform(512, 512, 6, seed=3)   # scattered columns
    with pytest.raises(ValueError, match="halo depth"):
        build_dist_plan(a, make_mesh_1d(8), x_mode="halo")
