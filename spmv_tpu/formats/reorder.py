"""Locality / reordering layer — the METIS layer rebuilt for x-windows.

Reference: ``HyperGraphInterface.cpp:59-147`` permutes rows by METIS k-way
partition id at handle-creation time (gated by OPT_LEVEL=3, common.c:144-156)
and caches the permutation on disk keyed by a matrix token
(``cache/<token>.bin``, HyperGraphInterface.cpp:22-57).  The caller gathers a
permuted x in and un-permutes y out (test_spmv.c:95-101, :130-137).

Here the goal is locality of the x gather: the reorder's job is to cluster
each row's column indices into few 1024-wide x-windows, so the gathers of
neighbouring rows hit the same cache lines, and to keep the column spread of
a row block small enough for the mesh plans' halo exchange.  We implement:

* :func:`rcm_order` — reverse Cuthill-McKee (pure numpy BFS; no external
  graph library in the image) for bandwidth reduction;
* :func:`window_cluster_order` — a lightweight column-clustering pass:
  order columns by their dominant row-block, so columns co-accessed by the
  same rows land in the same window (the role METIS partitioning plays in
  the reference);
* :func:`reorder_symmetric` — apply a permutation to rows+columns and return
  (A', perm) with the reference's x-permute/y-unpermute contract;
* an on-disk permutation cache keyed like the reference's
  (``cache/<token>.npz``).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

from ..types import CsrMatrix, INT_DTYPE

__all__ = ["rcm_order", "window_cluster_order", "cluster_order",
           "label_propagation_clusters", "cluster_split", "length_order",
           "reorder_symmetric", "reorder_rows", "cached_order", "bandwidth"]

_CACHE_DIR = "cache"  # same directory name as the reference


def bandwidth(a: CsrMatrix) -> int:
    """Max |col - row| over nonzeros (structure metric for DIA/RCM gating)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    return int(np.abs(a.colidx.astype(np.int64) - rows).max())


def rcm_order(a: CsrMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized structure.

    Returns ``perm`` such that row/col i of the reordered matrix is
    row/col ``perm[i]`` of the original.  Pure numpy BFS with
    degree-sorted neighbor visits; O(nnz log nnz).
    """
    if a.m != a.n:
        raise ValueError("RCM needs a square matrix")
    m = a.m
    # symmetrize structure: adjacency = pattern of A + A^T
    rows = np.repeat(np.arange(m, dtype=np.int64), a.row_lengths)
    cols = a.colidx.astype(np.int64)
    u = np.concatenate([rows, cols])
    v = np.concatenate([cols, rows])
    keep = u != v
    u, v = u[keep], v[keep]
    order = np.lexsort((v, u))
    u, v = u[order], v[order]
    if u.size:
        dedup = np.empty(u.size, dtype=bool)
        dedup[0] = True
        dedup[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
        u, v = u[dedup], v[dedup]
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, u + 1, 1)
    np.cumsum(indptr, out=indptr)
    deg = np.diff(indptr)

    visited = np.zeros(m, dtype=bool)
    result = np.empty(m, dtype=np.int64)
    pos = 0
    # process components in order of minimum degree start vertex
    start_order = np.argsort(deg, kind="stable")
    for s in start_order:
        if visited[s]:
            continue
        # BFS from s with degree-sorted neighbor expansion
        visited[s] = True
        frontier = [s]
        result[pos] = s
        pos += 1
        while frontier:
            nxt = []
            for node in frontier:
                nb = v[indptr[node]:indptr[node + 1]]
                nb = nb[~visited[nb]]
                if nb.size:
                    nb = nb[np.argsort(deg[nb], kind="stable")]
                    visited[nb] = True
                    result[pos:pos + nb.size] = nb
                    pos += nb.size
                    nxt.extend(nb.tolist())
            frontier = nxt
    return result[::-1].copy()  # the "reverse" in RCM


def window_cluster_order(a: CsrMatrix, window: int = 1024,
                         row_block: int = 1024) -> np.ndarray:
    """Column permutation clustering co-accessed columns into windows.

    For each column, find its dominant row-block (the row-block containing
    most of its nonzeros) and sort columns by (dominant block, first row).
    Columns read together end up in the same 1024-wide x-window.  This is
    the
    cheap-and-cheerful stand-in for the reference's METIS k-way clustering
    (HyperGraphInterface.cpp:90-92).
    """
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    rb = rows // row_block
    cols = a.colidx.astype(np.int64)
    # dominant row-block per column: mode of rb within each column group
    order = np.lexsort((rb, cols))
    c_s, rb_s = cols[order], rb[order]
    # count (col, rb) pair runs
    if c_s.size == 0:
        return np.arange(a.n, dtype=np.int64)
    new_run = np.empty(c_s.size, dtype=bool)
    new_run[0] = True
    new_run[1:] = (c_s[1:] != c_s[:-1]) | (rb_s[1:] != rb_s[:-1])
    run_id = np.cumsum(new_run) - 1
    run_len = np.bincount(run_id)
    run_col = c_s[new_run]
    run_rb = rb_s[new_run]
    # per column pick the run with max length
    best = {}
    for rc, rr, rl in zip(run_col, run_rb, run_len):
        cur = best.get(rc)
        if cur is None or rl > cur[0]:
            best[rc] = (rl, rr)
    dom = np.full(a.n, np.iinfo(np.int64).max, dtype=np.int64)
    for rc, (_, rr) in best.items():
        dom[rc] = rr
    return np.lexsort((np.arange(a.n), dom)).astype(np.int64)


def _sym_edges(a: CsrMatrix):
    """Deduplicated symmetric edge list (u, v) of the pattern of A + A^T."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    cols = a.colidx.astype(np.int64)
    u = np.concatenate([rows, cols])
    v = np.concatenate([cols, rows])
    keep = u != v
    u, v = u[keep], v[keep]
    if u.size:
        key = u * a.m + v
        order = np.argsort(key, kind="stable")
        key = key[order]
        dedup = np.empty(key.size, dtype=bool)
        dedup[0] = True
        dedup[1:] = key[1:] != key[:-1]
        u, v = u[order][dedup], v[order][dedup]
    return u, v


def _mode_per_node(m, u, lab_v):
    """Per-u most frequent label among (u, lab_v) pairs (ties → smallest).
    Returns (nodes, modes)."""
    order = np.argsort(u * m + lab_v, kind="stable")
    us, ls = u[order], lab_v[order]
    if us.size == 0:
        return us, ls
    new_run = np.empty(us.size, dtype=bool)
    new_run[0] = True
    new_run[1:] = (us[1:] != us[:-1]) | (ls[1:] != ls[:-1])
    run_id = np.cumsum(new_run) - 1
    run_len = np.bincount(run_id)
    run_u = us[new_run]
    run_lab = ls[new_run]
    u_starts = np.nonzero(np.concatenate(
        [[True], run_u[1:] != run_u[:-1]]))[0]
    best = np.maximum.reduceat(run_len, u_starts)
    is_best = run_len == np.repeat(best,
                                   np.diff(np.concatenate(
                                       [u_starts, [len(run_u)]])))
    cand = np.nonzero(is_best)[0]
    grp_of_cand = np.searchsorted(u_starts, cand, side="right") - 1
    idx_best = np.full(len(u_starts), np.iinfo(np.int64).max,
                       dtype=np.int64)
    np.minimum.at(idx_best, grp_of_cand, cand)
    return run_u[idx_best], run_lab[idx_best]


def label_propagation_clusters(a: CsrMatrix, rounds: int = 6,
                               min_cluster: int = 0) -> np.ndarray:
    """k-way graph clustering by weighted label propagation — the METIS
    min-cut role (HyperGraphInterface.cpp:59-147) without METIS.

    Each round every node adopts the most frequent label among its
    neighbors (ties → smallest label; vectorized as a sort + run-count +
    per-node argmax).  Converges in a few rounds on community-structured
    graphs; returns (m,) labels renumbered densely in first-seen order.
    """
    if a.m != a.n:
        raise ValueError("clustering needs a square matrix")
    u, v = _sym_edges(a)
    labels = np.arange(a.m, dtype=np.int64)
    for _ in range(rounds):
        nodes, modes = _mode_per_node(a.m, u, labels[v])
        new_labels = labels.copy()
        new_labels[nodes] = modes
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    if min_cluster > 0:
        # absorb fragment clusters: their nodes keep edges into their true
        # community, which would otherwise become long-range edges after
        # ordering (observed as halo-depth blowup)
        for _ in range(3):
            sizes = np.bincount(labels, minlength=a.m)
            small = sizes[labels] < min_cluster
            if not small.any():
                break
            sel = small[u] & ~small[v]   # edges from fragment → large
            nodes, modes = _mode_per_node(a.m, u[sel], labels[v[sel]])
            labels[nodes] = modes
    # renumber densely in first-seen order
    _, first_idx, inv = np.unique(labels, return_index=True,
                                  return_inverse=True)
    rank = np.argsort(np.argsort(first_idx))
    return rank[inv]


def cluster_order(a: CsrMatrix, rounds: int = 6,
                  min_cluster: Optional[int] = None) -> np.ndarray:
    """Row/col permutation grouping label-propagation clusters contiguously.

    Where RCM only recovers *banded* structure, this recovers block/
    community structure: co-connected rows land in consecutive ids, so
    their columns share x-windows (the SELL-8W gate) and mesh shards cut
    few edges (halo minimization) — the role METIS k-way plays in the
    reference (common.c:144-156).
    """
    if min_cluster is None:
        min_cluster = max(a.m // 256, 16)
    labels = label_propagation_clusters(a, rounds=rounds,
                                        min_cluster=min_cluster)
    # Order clusters by CONNECTIVITY, not id: label propagation sometimes
    # splits one community into two labels; a greedy max-weight chain over
    # the cluster graph keeps such halves adjacent (else their mutual edges
    # become long-range and inflate windows/halo rings).
    u, v = _sym_edges(a)
    nc = int(labels.max()) + 1 if labels.size else 0
    rank = np.zeros(nc, dtype=np.int64)
    if 1 < nc <= 4096 and u.size:   # dense cluster graph; skip when huge
        lu, lv = labels[u], labels[v]
        off = lu != lv
        w = np.zeros((nc, nc), dtype=np.int64)
        if off.any():
            np.add.at(w, (lu[off], lv[off]), 1)
            w = w + w.T
        sizes = np.bincount(labels, minlength=nc)
        visited = np.zeros(nc, dtype=bool)
        chain = [int(np.argmax(sizes))]
        visited[chain[0]] = True
        for _ in range(nc - 1):
            cand = w[chain[-1]].astype(np.float64).copy()
            cand[visited] = -1
            if cand.max() <= 0:              # no edge from chain end:
                cand = w[chain].sum(axis=0).astype(np.float64)  # any visited
                cand[visited] = -1
                if cand.max() <= 0:
                    cand = sizes.astype(np.float64).copy()      # disconnected
                    cand[visited] = -1
            nxt = int(np.argmax(cand))
            visited[nxt] = True
            chain.append(nxt)
        rank[np.asarray(chain)] = np.arange(nc)
    return np.lexsort((np.arange(a.m), rank[labels])).astype(np.int64)


def cluster_split(a: CsrMatrix, nparts: int, rounds: int = 6):
    """(perm, splitter): cluster-contiguous order + nnz-balanced row cuts.

    The splitter cuts the *reordered* matrix into ``nparts`` contiguous row
    blocks balanced by nnz; because the order groups clusters, cuts fall
    between communities when balance allows — nnz-balanced AND
    halo-minimal shards for ``build_dist_plan`` (numa.c:277-304 analog).
    """
    from .partition import balanced_row_splitter
    perm = cluster_order(a, rounds=rounds)
    ap = a.permute_rows(perm.astype(INT_DTYPE))
    splitter = balanced_row_splitter(ap.rowptr, nparts)
    return perm, splitter


def reorder_rows(a: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """Row-only permutation (y' = y[perm]; x unchanged)."""
    return a.permute_rows(perm.astype(INT_DTYPE))


def reorder_symmetric(a: CsrMatrix,
                      perm: np.ndarray) -> Tuple[CsrMatrix, np.ndarray]:
    """Permute rows AND columns by ``perm`` (square matrices).

    Contract (reference test_spmv.c:95-101,:130-137): with
    ``(A', perm) = reorder_symmetric(A, perm)``, computing
    ``y' = A' @ x[perm]`` gives ``y = scatter(y', perm)``, i.e.
    ``y[perm[i]] = y'[i]``.
    """
    if a.m != a.n:
        raise ValueError("symmetric reorder needs a square matrix")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    ap = a.permute_rows(perm.astype(INT_DTYPE))
    # renumber columns: new col id = inv[old col id]; re-sort within rows
    rows = np.repeat(np.arange(ap.m, dtype=np.int64), ap.row_lengths)
    cols = inv[ap.colidx]
    return CsrMatrix.from_coo(ap.m, ap.n, rows.astype(INT_DTYPE),
                              cols.astype(INT_DTYPE), ap.vals,
                              sum_duplicates=False), perm


def length_order(a: CsrMatrix) -> np.ndarray:
    """Rows sorted by descending nnz — the reference's SELL σ-sort
    (sell_C_Sigma_spmv.c:222) taken global.

    On heavy-tailed (power-law) matrices the natural order pads SELL
    slices to their one mega-row's depth.  Length-sorting clusters heavy
    rows into the same 128-row slices, so slice depths follow row lengths.
    Stable sort keeps equal-length rows in natural order (column locality
    of the light tail is preserved up to slice granularity).
    """
    return np.argsort(-a.row_lengths.astype(np.int64),
                      kind="stable").astype(np.int64)


def cached_order(a: CsrMatrix, token: str, kind: str = "rcm",
                 cache_dir: Optional[str] = None) -> np.ndarray:
    """Disk-cached permutation, keyed like the reference's partition cache
    (m, nnz, token → ``cache/<mangled>.npz``, HyperGraphInterface.cpp:22-57).
    """
    mangled = re.sub(r"[^A-Za-z0-9_.-]", "_", f"{token}_{kind}_{a.m}_{a.nnz}")
    path = os.path.join(cache_dir or _CACHE_DIR, mangled + ".npz")
    # Cheap structure fingerprint: (m, nnz) collisions with a DIFFERENT
    # structure would silently reuse a stale permutation (correctness is
    # unaffected — permute/unpermute is internal — but the locality benefit
    # would be silently lost).
    fp_src = np.concatenate([a.rowptr[:: max(a.m // 64, 1)].astype(np.uint64),
                             a.colidx[:: max(a.nnz // 256, 1)].astype(np.uint64)])
    with np.errstate(over="ignore"):
        fingerprint = int(np.bitwise_xor.reduce(
            fp_src * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(1))
    if os.path.exists(path):
        z = np.load(path)
        if (int(z["m"]) == a.m and int(z["nnz"]) == a.nnz
                and ("fp" in z and int(z["fp"]) == fingerprint)):
            return z["perm"]
    if kind == "rcm":
        perm = rcm_order(a)
    elif kind == "window":
        perm = window_cluster_order(a)
    elif kind == "cluster":
        perm = cluster_order(a)
    elif kind == "length":
        perm = length_order(a)
    else:
        raise ValueError(f"unknown reorder kind {kind!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, m=a.m, nnz=a.nnz, fp=fingerprint, perm=perm)
    return perm
