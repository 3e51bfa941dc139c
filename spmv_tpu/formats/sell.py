"""Chunked SELL-C-σ packing.

Reference: ``sell_C_Sigma_get_handle_Selected`` (sell_C_Sigma_spmv.c:141-247)
builds σ-sorted, C-row slices stored column-major with −1 column sentinels,
sized for 4/8-wide AVX2 FMA.  This layout:

* **C = 128 rows per slice**; the inner op
  ``y[0:C] += vals[j, 0:C] * x[cols[j, 0:C]]`` is one 128-wide gather+FMA
  that XLA fuses with the chunk reduction.
* **Depth in chunks of 8**: each slice's depth (max row length in the
  slice) pads to a multiple of 8 instead of a power of two, which keeps the
  padding near 1.1× on uniform-random matrices.  All slices pack into ONE
  flat ``(C_total, 8, 128)`` chunk stream (cols + vals) with a per-chunk
  slice id, so execution is a single fused gather+FMA+chunk-reduce followed
  by one small sorted segment-sum over chunk partials — no per-depth bucket
  dispatch.
* **Padding uses column 0 + value 0** (instead of the reference's −1 sentinel
  + branch, sell_C_Sigma_spmv.c:124): gathered garbage × 0 = 0, branch-free.
* The row scatter (reference scatters ``Y[RowIndex]``, inner_spmv.h:473-475)
  is inverted into one precomputed inverse-permutation *gather*.

The chunk shape (C = 128, depth granularity 8) was tuned on the previous
accelerator's 8×128 register tile and is untuned on the H100 — an open
measurement (ROADMAP.md).

With ``sigma <= 1`` (no sorting) this degrades to plain chunked-ELL slices in
natural row order (identity output order) — used for ``Method_Parallel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import CsrMatrix, INT_DTYPE

__all__ = ["SellMatrix", "pack_sell", "LANES", "SUBLANES"]

LANES = 128      # slice height C (untuned on the H100)
SUBLANES = 8     # depth granularity (untuned on the H100)


@dataclasses.dataclass(frozen=True)
class SellMatrix:
    """Flat chunked SELL-C-σ arrays (host-side; device placement in handle)."""

    m: int
    n: int
    nnz_stored: int          # true nnz (pre-padding)
    c: int
    sigma: int
    nslices: int
    cols: np.ndarray         # (nchunks, SUBLANES, LANES) int32, padding → 0
    vals: np.ndarray         # (nchunks, SUBLANES, LANES) dtype, padding → 0
    chunk_ids: np.ndarray    # (nchunks,) int32 slice id per chunk (sorted)
    inv_pos: np.ndarray      # (m,) int32: position of orig row i in the
                             # slice-major output vector (nslices*LANES,)
    identity_order: bool     # True when inv_pos is the identity (ELL mode)

    @property
    def padded_nnz(self) -> int:
        return self.cols.size


def pack_sell(a: CsrMatrix, c: int = LANES, sigma: int = 32 * LANES,
              sub: int = SUBLANES) -> SellMatrix:
    """Pack CSR into flat chunked SELL-C-σ.

    ``sigma`` is the sorting-window size in rows; ``sigma <= 1`` disables
    sorting (ELL mode).  The reference derives σ = C·(m/threads/C) at handle
    time (common.c:139-140, sell_C_Sigma_spmv.c:148); here it is an explicit
    knob the inspector sets.
    """
    if c != LANES:
        raise ValueError(f"c must be {LANES}: the chunk stream is "
                         f"(nchunks, {SUBLANES}, {LANES})")
    m_pad = max(-(-a.m // c) * c, c)
    lengths = np.zeros(m_pad, dtype=np.int64)
    lengths[: a.m] = a.row_lengths

    # σ-window sort by descending length (stable), like the reference's qsort
    # within each σ block (sell_C_Sigma_spmv.c:220-222).
    if sigma > 1:
        sigma = -(-sigma // c) * c
        grid = -(-m_pad // sigma) * sigma
        lens_w = np.full(grid, -1, dtype=np.int64)
        lens_w[:m_pad] = lengths
        order = (np.argsort(-lens_w.reshape(-1, sigma), axis=1, kind="stable")
                 + np.arange(0, grid, sigma)[:, None]).reshape(-1)
        order = order[order < m_pad]
    else:
        order = np.arange(m_pad, dtype=np.int64)

    nslices = m_pad // c
    slice_rows = order.reshape(nslices, c)            # orig row ids per slice
    slice_len = lengths[slice_rows]                   # (nslices, c)
    depth = np.maximum(-(-slice_len.max(axis=1) // sub) * sub, sub)
    nchunks = depth // sub                            # chunks per slice
    chunk0 = np.zeros(nslices + 1, dtype=np.int64)
    np.cumsum(nchunks, out=chunk0[1:])
    total_chunks = int(chunk0[-1])

    # Vectorized scatter fill: nonzero k of row r goes to flat position
    # (chunk0[slice(r)] + j//sub, j%sub, lane(r)) where j = k - rowptr[r].
    slice_of_row = np.empty(m_pad, dtype=np.int64)
    lane_of_row = np.empty(m_pad, dtype=np.int64)
    slice_of_row[slice_rows.ravel()] = np.repeat(np.arange(nslices), c)
    lane_of_row[slice_rows.ravel()] = np.tile(np.arange(c), nslices)

    rowptr64 = a.rowptr.astype(np.int64)
    row_of = np.repeat(np.arange(a.m, dtype=np.int64),
                       np.diff(rowptr64).astype(np.int64))
    j_within = np.arange(a.nnz, dtype=np.int64) - rowptr64[row_of]
    s = slice_of_row[row_of]
    dest = ((chunk0[s] + j_within // sub) * (sub * c)
            + (j_within % sub) * c + lane_of_row[row_of])

    cols_flat = np.zeros(total_chunks * sub * c, dtype=INT_DTYPE)
    vals_flat = np.zeros(total_chunks * sub * c, dtype=a.vals.dtype)
    cols_flat[dest] = a.colidx
    vals_flat[dest] = a.vals

    chunk_ids = np.repeat(np.arange(nslices, dtype=INT_DTYPE),
                          nchunks.astype(np.int64))

    # inverse permutation: orig row i sits at slice_of*c + lane_of
    pos_of = slice_of_row * c + lane_of_row
    inv_pos = pos_of[: a.m].astype(INT_DTYPE)
    identity = bool(np.array_equal(inv_pos, np.arange(a.m, dtype=INT_DTYPE)))
    return SellMatrix(
        m=a.m, n=a.n, nnz_stored=a.nnz, c=c, sigma=max(int(sigma), 1),
        nslices=nslices,
        cols=cols_flat.reshape(total_chunks, sub, c),
        vals=vals_flat.reshape(total_chunks, sub, c),
        chunk_ids=chunk_ids, inv_pos=inv_pos, identity_order=identity,
    )
