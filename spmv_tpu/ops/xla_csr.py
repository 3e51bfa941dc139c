"""Pure-XLA SpMV execution plans.

These are the compiler-lowered equivalents of the reference's method bodies
(L2, e.g. serial_spmv.c / parallel_balanced_Yid_spmv.c): jittable functions
over static-shape device arrays built at handle time.  Three design rules,
taken from the device's memory model rather than the reference's thread
model:

1. the only irregular memory op is the ``x[colidx]`` gather (the same hot
   gather as the reference's ``x[indx[k]]``, inner_spmv.h:255-258);
2. **no scatter-add anywhere** — row sums come out of prefix-scan differences
   or slice reductions followed by an inverse-permutation *gather*;
3. everything is shape-static so one jitted executable serves every call
   (the reference's handle contract, include/spmv.h:55-64).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "gather_x",
    "segment_sum_spmv",
    "scan_spmv_global",
    "scan_spmv_tiled",
    "balanced2_spmv",
    "sell_spmv",
    "dia_spmv",
    "bcsr_spmv",
]


def gather_x(x: jax.Array, idx: jax.Array) -> jax.Array:
    """The hot gather. Indices are in-bounds by construction (padding → 0)."""
    return x.at[idx].get(mode="promise_in_bounds", unique_indices=False)


def segment_sum_spmv(rows, colidx, vals, x, *, m: int):
    """Method_Serial plan: naive gather + sorted segment-sum (scatter-add).

    The straight-line translation of the reference's serial row loop
    (serial_spmv.c:9-37) into one gather + one segment reduction.  Kept as
    the simplest correct program; the balanced plans below avoid its
    scatter-add.

    The optimization_barrier keeps the gather pipeline out of the
    scatter-add consumer's fusion: on an H100 the fused form was 1.3×
    slower (PERF.md, barrier pairs).
    """
    prod = vals * gather_x(x, colidx)
    prod = jax.lax.optimization_barrier(prod)
    return jax.ops.segment_sum(prod, rows, num_segments=m,
                               indices_are_sorted=True)


def scan_spmv_global(colidx_pad, vals_pad, row_start, row_end, x):
    """Method_BalancedYid plan: exact-nnz split via one global prefix scan.

    The reference splits the nnz stream exactly evenly and fixes up partial
    rows with serial carry loops (parallel_balanced_Yid_spmv.c:16-53,
    :151-156).  A prefix sum over the product stream subsumes all of that:
    every row is ``csum[end] - csum[start]`` (streams carry one prepended
    zero so the inclusive scan is an exclusive prefix — see
    formats/partition.py).
    """
    prod = vals_pad * gather_x(x, colidx_pad)
    csum = jnp.cumsum(prod)
    return gather_x(csum, row_end) - gather_x(csum, row_start)


def scan_spmv_tiled(colidx_pad, vals_pad, row_start, row_end, x, *, tile: int):
    """Method_Balanced plan: two-level (tile + carry) prefix scan.

    Same algebra as :func:`scan_spmv_global` but the scan is hierarchical:
    an independent scan per equal-nnz tile (the analog of the reference's
    per-thread nnz quantiles, parallel_balanced_spmv.c:39-58) plus a tiny
    carry scan across tiles (the analog of CSR5's calibrator,
    csr5_spmv_avx2.h:320-335).  Exposes tile-level parallelism to the
    compiler and keeps partial sums short for f32 accuracy.
    """
    prod = (vals_pad * gather_x(x, colidx_pad)).reshape(-1, tile)
    local = jnp.cumsum(prod, axis=1)
    carry = jnp.cumsum(local[:, -1])
    carry = jnp.concatenate([jnp.zeros((1,), carry.dtype), carry[:-1]])
    csum = (local + carry[:, None]).reshape(-1)
    return gather_x(csum, row_end) - gather_x(csum, row_start)


def balanced2_spmv(colidx_pad, vals_pad, vrow_start, vrow_end,
                   sub_start, sub_end, x, *, tile: int):
    """Method_Balanced2 plan: mega-row split + two-level reduction.

    Stage 1 computes every *virtual sub-row* (mega-rows pre-split into
    ≤ tile-nnz chunks at handle time, formats/partition.py) with the tiled
    scan; stage 2 folds sub-row runs back into rows with a second short
    prefix scan — the scan-algebra equivalent of the reference's per-thread
    partial sums + serial reduction (parallel_balanced2_spmv.c:264-282).
    """
    y_v = scan_spmv_tiled(colidx_pad, vals_pad, vrow_start, vrow_end, x,
                          tile=tile)
    csum2 = jnp.concatenate([jnp.zeros((1,), y_v.dtype), jnp.cumsum(y_v)])
    return gather_x(csum2, sub_end) - gather_x(csum2, sub_start)


def sell_spmv(cols, vals, chunk_ids, inv_pos, x, *, nslices: int,
              identity_order: bool):
    """Method_SellCSigma / Method_Parallel plan: flat chunked SELL slices.

    ``cols``/``vals`` are the (nchunks, 8, 128) chunk stream; one fused
    gather+FMA+chunk-reduce produces per-chunk lane partials (nchunks, 128) —
    a 128-wide line product (vs inner_spmv.h:411-477's C-wide AVX2
    columns) — then a sorted segment-sum folds chunks into their slices and
    one inverse-permutation gather restores row order (the reference
    scatters to ``Y[RowIndex]`` instead, sell_C_Sigma_spmv.c:283-287).

    The optimization_barrier keeps the gather pipeline out of the
    segment-sum's scatter fusion: on an H100 the fused form was up to 5%
    slower and never faster (PERF.md, barrier pairs).
    """
    part = jnp.sum(vals * gather_x(x, cols), axis=1)       # (nchunks, 128)
    part = jax.lax.optimization_barrier(part)
    y_slices = jax.ops.segment_sum(part, chunk_ids, num_segments=nslices,
                                   indices_are_sorted=True)
    y_all = y_slices.reshape(-1)
    if identity_order:
        return y_all[: inv_pos.shape[0]]
    return gather_x(y_all, inv_pos)


def dia_spmv(data, x, *, offsets: tuple, m: int, n: int):
    """Method_Dia plan: banded SpMV as shifted-stream FMAs — zero gathers.

    ``y[i] = Σ_d data[d, i] · x[i + offsets[d]]`` with out-of-range x
    reading zero padding.  All slices are static, so XLA lowers this to
    one fused streaming loop with no index stream at all.  No counterpart
    in the reference (its AVX2 row kernels treat bands like any rows); the
    inspector picks it for high diagonal fill.
    """
    if not offsets:                      # empty matrix: y = 0
        return jnp.zeros(m, x.dtype)
    omin = min(offsets)
    omax = max(offsets)
    pad_l = max(0, -omin)
    pad_r = max(0, m + omax - n)
    xpad = jnp.concatenate([
        jnp.zeros(pad_l, x.dtype), x, jnp.zeros(max(pad_r, 0), x.dtype)])
    acc = jnp.zeros(m, x.dtype)
    for d, o in enumerate(offsets):
        seg = jax.lax.dynamic_slice_in_dim(xpad, pad_l + o, m)
        acc = acc + data[d] * seg
    return acc


def bcsr_spmv(blocks, block_rows, block_cols, x, *, m: int,
              nblock_rows: int):
    """Method_Bcsr plan: batched 128×128 dense-block matrix-vector products.

    All irregularity collapses to block granularity: one row-gather of x
    blocks and one sorted segment-sum of block partials per 128² block —
    1/128th the irregular-op count of any per-nonzero plan.  The einsum runs
    at ``Precision.HIGHEST``: a default-precision f32 contraction may run in
    TF32 on GPUs, which misses the f32 tolerance.
    """
    n_pad = -(-x.shape[0] // 128) * 128
    if n_pad != x.shape[0]:
        x = jnp.concatenate([x, jnp.zeros(n_pad - x.shape[0], x.dtype)])
    x2 = x.reshape(-1, 128)
    xb = x2[block_cols]                                   # (nb, 128) gather
    acc_t = blocks.dtype if blocks.dtype == jnp.float64 else jnp.float32
    # bf16 blocks (lossless storage) upcast in-register; accumulate f32
    partial = jnp.einsum("bij,bj->bi", blocks.astype(acc_t), xb,
                         preferred_element_type=acc_t,
                         precision=jax.lax.Precision.HIGHEST)
    y2 = jax.ops.segment_sum(partial, block_rows,
                             num_segments=nblock_rows,
                             indices_are_sorted=True)
    return y2.reshape(-1)[:m]
