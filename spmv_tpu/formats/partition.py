"""Host-side partition planning: the device analog of the reference's splitters.

The reference computes, at handle-creation time, per-thread work assignments:
nnz-quantile row boundaries (``init_csrSplitter_balanced``,
parallel_balanced_spmv.c:39-58), mega-row redistribution plans
(``parallel_balanced2_get_handle``, parallel_balanced2_spmv.c:55-209) and
exact-nnz splits with partial-row carries (``init_splitter_balancedYid``,
parallel_balanced_Yid_spmv.c:16-53).  On the device there are no threads to
assign —
instead these become *static partition metadata baked into the jitted
executable*: tile boundaries, padded streams, and row-extraction indices, all
computed here in numpy once per matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import CsrMatrix, INT_DTYPE

__all__ = [
    "balanced_row_splitter",
    "row_ids",
    "pad_stream",
    "TileScanPlan",
    "build_tile_scan_plan",
    "Balanced2Plan",
    "build_balanced2_plan",
]


def balanced_row_splitter(rowptr: np.ndarray, nblocks: int) -> np.ndarray:
    """nnz-quantile row boundaries: block b owns rows [s[b], s[b+1]).

    Semantics of the reference's ``init_csrSplitter_balanced``
    (parallel_balanced_spmv.c:39-58): stride ceil(nnz/B), binary-search the
    row boundary per block, then enforce monotonicity.  Whole rows only —
    a mega-row larger than the stride lands in one block (the case balanced2
    exists for).  Used for mesh row-sharding and row-blocked execution.
    """
    m = len(rowptr) - 1
    nnz = int(rowptr[-1])
    if nblocks <= 0:
        raise ValueError("nblocks must be positive")
    stride = -(-max(nnz, 1) // nblocks)
    targets = np.arange(1, nblocks, dtype=np.int64) * stride
    cuts = np.searchsorted(rowptr, targets, side="left").astype(np.int64)
    splitter = np.concatenate([[0], cuts, [m]])
    # monotonicity fix (reference parallel_balanced_spmv.c:51-55)
    np.maximum.accumulate(splitter, out=splitter)
    return np.minimum(splitter, m).astype(INT_DTYPE)


def row_ids(a: CsrMatrix) -> np.ndarray:
    """COO row id per nonzero (sorted, CSR order)."""
    return np.repeat(np.arange(a.m, dtype=INT_DTYPE), a.row_lengths)


def pad_stream(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pad a 1-D stream to a multiple of `multiple` with `fill`."""
    pad = (-len(arr)) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])


@dataclasses.dataclass(frozen=True)
class TileScanPlan:
    """Static metadata for scan-based zero-scatter CSR execution.

    The nnz stream is padded to ``ntiles × tile`` and summed with a
    hierarchical (within-tile + carry) prefix scan; each row's value is then
    extracted as ``csum[end]-csum[start]`` — the device-side generalization of
    every reference balanced splitter: an *exact* nnz split with all
    partial-row carries handled by the scan, no scatter-add anywhere.
    """

    tile: int
    ntiles: int
    colidx_pad: np.ndarray  # (ntiles*tile,) int32; one zero PREPENDED, 0-padded
    vals_pad: np.ndarray    # (ntiles*tile,) dtype; one zero PREPENDED, 0-padded
    # With the prepended zero, the INCLUSIVE scan of vals_pad*x[colidx_pad] at
    # position k equals the exclusive prefix sum of the original stream at k,
    # so y[i] = csum[rowptr[i+1]] - csum[rowptr[i]] with no boundary special
    # case and no scatter (the reference handles the same carries with serial
    # fix-up loops, parallel_balanced_Yid_spmv.c:151-156).
    row_start: np.ndarray   # (m,) int32 positions into the padded stream
    row_end: np.ndarray     # (m,)


def build_tile_scan_plan(a: CsrMatrix, tile: int = 2048) -> TileScanPlan:
    colidx = np.concatenate([np.zeros(1, dtype=INT_DTYPE), a.colidx])
    vals = np.concatenate([np.zeros(1, dtype=a.vals.dtype), a.vals])
    colidx_pad = pad_stream(colidx, tile, 0)
    vals_pad = pad_stream(vals, tile, a.vals.dtype.type(0))
    ntiles = len(colidx_pad) // tile
    row_start = a.rowptr[:-1].astype(INT_DTYPE)
    row_end = a.rowptr[1:].astype(INT_DTYPE)
    return TileScanPlan(tile, ntiles, colidx_pad, vals_pad, row_start, row_end)


@dataclasses.dataclass(frozen=True)
class Balanced2Plan:
    """Mega-row split plan — the distinct Balanced2 algorithm.

    The reference's Balanced2 exists for rows so heavy they span several
    threads' nnz quantiles: it redistributes them and splits them intra-row,
    reducing per-thread partials serially at the end
    (parallel_balanced2_spmv.c:55-209, :264-282).  The translation here:
    mega-rows (> ``tile`` nonzeros) become runs of *virtual sub-rows* of at
    most ``tile`` nonzeros each; stage 1 computes every virtual row with the
    ordinary tile-scan extraction, stage 2 folds each row's sub-row run with
    a second (much shorter) prefix scan — the scan-algebra form of the
    reference's ``Y[Yid[tid]] += Ysum[tid]`` serial reduction.
    """

    inner: TileScanPlan          # over the virtual (sub-row) matrix
    m_virtual: int
    sub_ptr_start: np.ndarray    # (m,) int32 — row i's first virtual row
    sub_ptr_end: np.ndarray      # (m,) int32 — one past row i's last
    n_mega_rows: int


def build_balanced2_plan(a: CsrMatrix, tile: int = 1024):
    """Build the mega-row split plan, or return ``None`` when no row exceeds
    ``tile`` nonzeros — the caller then demotes the method to Balanced,
    exactly the reference's rule (parallel_balanced2_spmv.c:87-90)."""
    lengths = a.row_lengths.astype(np.int64)
    n_mega = int(np.sum(lengths > tile))
    if n_mega == 0:
        return None
    nchunks = np.maximum(-(-lengths // tile), 1)
    m_v = int(nchunks.sum())
    sub_end = np.cumsum(nchunks)
    sub_start = sub_end - nchunks
    # virtual rowptr: row i's chunks split at every `tile` nonzeros
    vrowptr = np.zeros(m_v + 1, dtype=np.int64)
    row_of_chunk = np.repeat(np.arange(a.m), nchunks)
    chunk_in_row = np.arange(m_v) - sub_start[row_of_chunk]
    vrowptr[:-1] = a.rowptr.astype(np.int64)[row_of_chunk] \
        + chunk_in_row * tile
    vrowptr[:-1] = np.minimum(vrowptr[:-1],
                              a.rowptr.astype(np.int64)[row_of_chunk + 1])
    vrowptr[-1] = a.nnz
    virtual = CsrMatrix(m_v, a.n, vrowptr.astype(INT_DTYPE), a.colidx,
                        a.vals)
    return Balanced2Plan(
        inner=build_tile_scan_plan(virtual, tile=tile),
        m_virtual=m_v,
        sub_ptr_start=sub_start.astype(INT_DTYPE),
        sub_ptr_end=sub_end.astype(INT_DTYPE),
        n_mega_rows=n_mega,
    )
