"""Locality: label-propagation clustering (the METIS k-way role,
HyperGraphInterface.cpp:59-147) measured by x-window locality and wired to
the distributed halo plans."""

import numpy as np
import pytest

from spmv_tpu.formats import reorder
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.types import CsrMatrix


def _shuffled_communities(ncomm=8, size=1024, within=16, inter=0.02,
                          seed=0):
    """Community graph with node ids RANDOMLY SHUFFLED plus a sprinkle of
    inter-community edges: block structure exists but is invisible to
    bandwidth-reduction (RCM) ordering — BFS hops across communities."""
    rng = np.random.default_rng(seed)
    m = ncomm * size
    shuffle = rng.permutation(m)
    rows_l, cols_l = [], []
    for c in range(ncomm):
        base = c * size
        r = rng.integers(base, base + size, size=size * within)
        co = rng.integers(base, base + size, size=size * within)
        rows_l.append(r)
        cols_l.append(co)
    n_inter = int(m * within * inter)
    rows_l.append(rng.integers(0, m, size=n_inter))
    cols_l.append(rng.integers(0, m, size=n_inter))
    rows = shuffle[np.concatenate(rows_l)]
    cols = shuffle[np.concatenate(cols_l)]
    vals = generate.exact_values(rng, rows.size, np.float32)
    return CsrMatrix.from_coo(m, m, rows, cols, vals)


def _window_spread(a, row_block=128, window=1024, min_pair=16):
    """x-window locality, device-neutral.

    Returns ``(spread, straggler_frac)``: the (128-row block, 1024-column
    window) pairs holding at least ``min_pair`` nonzeros, per 1024
    nonzeros, and the share of nonzeros in sparser pairs.  Few dense pairs
    mean neighbouring rows gather from the same x-windows."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    nwin = -(-a.n // window)
    key = (rows // row_block) * nwin + a.colidx.astype(np.int64) // window
    _, cnt = np.unique(key, return_counts=True)
    dense = cnt >= min_pair
    nnz = max(a.nnz, 1)
    return dense.sum() * window / nnz, cnt[~dense].sum() / nnz


def test_cluster_order_recovers_communities_where_rcm_fails():
    a = _shuffled_communities()
    assert _window_spread(a)[0] > 3.0            # natural order: scattered
    rcm, _ = reorder.reorder_symmetric(a, reorder.rcm_order(a))
    clu, _ = reorder.reorder_symmetric(a, reorder.cluster_order(a))
    # RCM interleaves the shuffled communities; label propagation finds
    # them (stragglers = the sprinkled inter-community edges)
    spread_clu, frac_clu = _window_spread(clu)
    spread_rcm, _ = _window_spread(rcm)
    assert spread_clu <= 3.0 and frac_clu <= 0.05
    assert spread_clu < spread_rcm


def test_cluster_reorder_handle_correctness():
    from spmv_tpu import create_handle, spmv, Method
    a = _shuffled_communities(ncomm=4, size=150, within=6, seed=1)
    h = create_handle(a, method=Method.SERIAL, reorder="cluster")
    x = generate.make_x(a.n, np.float32, kind="normal", seed=2)
    np.testing.assert_allclose(
        np.asarray(spmv(h, x)),
        spmv_golden(a.astype(np.float64), x.astype(np.float64)),
        rtol=2e-5, atol=1e-4)


def test_label_propagation_finds_planted_clusters():
    a = _shuffled_communities(ncomm=6, size=200, within=8, seed=3)
    labels = reorder.label_propagation_clusters(a)
    # rows of one planted community should mostly share a label
    # (reconstruct the planting from the generator's determinism)
    rng = np.random.default_rng(3)
    m = 6 * 200
    shuffle = rng.permutation(m)
    purity = []
    for c in range(6):
        members = shuffle[np.arange(c * 200, (c + 1) * 200)]
        _, counts = np.unique(labels[members], return_counts=True)
        purity.append(counts.max() / 200)
    assert np.mean(purity) > 0.9


def test_cluster_split_balances_nnz():
    a = _shuffled_communities(seed=4)
    perm, splitter = reorder.cluster_split(a, 8)
    ap = a.permute_rows(perm.astype(np.int32))
    nnz_per = np.diff(ap.rowptr.astype(np.int64)[splitter])
    assert nnz_per.max() <= 1.3 * a.nnz / 8


def test_halo_on_nnz_balanced_split():
    """Generalized halo mode: nnz-balanced rows + uniform x blocks."""
    import jax
    from spmv_tpu.parallel import build_dist_plan, dist_spmv, make_mesh_1d

    # banded but with skewed row lengths so the nnz split is non-uniform
    rng = np.random.default_rng(5)
    m = 4096
    lens = np.where(np.arange(m) < m // 4, 24, 4)
    rows = np.repeat(np.arange(m), lens)
    cols = np.clip(rows + rng.integers(-60, 61, size=rows.size), 0, m - 1)
    a = CsrMatrix.from_coo(m, m, rows, cols,
                           generate.exact_values(rng, rows.size, np.float64))
    mesh = make_mesh_1d(8)
    plan = build_dist_plan(a, mesh, x_mode="halo")
    assert np.any(np.diff(plan.row_splitter) !=
                  np.diff(plan.row_splitter)[0])   # genuinely non-uniform
    x = generate.make_x(a.n, np.float64, kind="normal", seed=6)
    y = np.asarray(dist_spmv(plan, x))
    np.testing.assert_allclose(y, spmv_golden(a, x), rtol=1e-9)


def test_halo_raises_on_global_columns():
    from spmv_tpu.parallel import build_dist_plan, make_mesh_1d
    a = generate.random_uniform(2048, 2048, 6, dtype=np.float64, seed=7)
    with pytest.raises(ValueError, match="halo depth"):
        build_dist_plan(a, make_mesh_1d(8), x_mode="halo")


def test_cluster_split_then_halo_small_ring():
    """The locality pass shrinks the computed ring depth on a community
    graph (halo-minimal shards, the numa.c:277-304 analog)."""
    from spmv_tpu.parallel import build_dist_plan, dist_spmv, make_mesh_1d
    a = _shuffled_communities(ncomm=8, size=256, within=6, inter=0.0,
                              seed=8)
    perm, _ = reorder.cluster_split(a, 8)
    ap, _ = reorder.reorder_symmetric(a, perm)
    mesh = make_mesh_1d(8)
    plan = build_dist_plan(ap, mesh, x_mode="halo")
    assert plan._halo <= 2                        # communities ~ shards
    x = generate.make_x(ap.n, np.float32, kind="normal", seed=9)
    y = np.asarray(dist_spmv(plan, x))
    np.testing.assert_allclose(
        y, spmv_golden(ap.astype(np.float64), x.astype(np.float64)),
        rtol=2e-5, atol=1e-3)
