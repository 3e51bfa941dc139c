"""Bytes-moved / roofline model (reference ``getB``/``getFLOP``, utils.h:11-19).

The reference models SpMV traffic as ``(m+1+nnz)·sizeof(int) +
(2·nnz+m)·sizeof(val)`` (rowptr + colidx reads, val + x-gather reads, y
write) and FLOPs as ``2·nnz``; this module reproduces that model per format
so benchmark output can report bandwidth efficiency.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bytes_moved", "roofline_gflops", "FLOP_PER_NNZ"]

FLOP_PER_NNZ = 2


def bytes_moved(m: int, n: int, nnz: int, val_bytes: int = 4,
                idx_bytes: int = 4, fmt: str = "csr",
                pad_ratio: float = 1.0,
                stored_val_bytes: int | None = None) -> int:
    """Traffic model per SpMV execution.

    ``csr``: the reference's model (utils.h:11-14).
    ``dia``: the diagonal planes at their stored width (``stored_val_bytes``,
    e.g. 2 for lossless bf16 diagonals; ``val_bytes`` by default) + x read
    once + y written once.  ``pad_ratio`` = ndiags·m/nnz.  The shifted
    slices of neighbouring diagonals reuse x through the cache, so x is
    not counted per diagonal.
    """
    if fmt == "csr":
        return (m + 1 + nnz) * idx_bytes + (2 * nnz + m) * val_bytes
    if fmt == "dia":
        padded = int(nnz * pad_ratio)          # ndiags * m
        stored = val_bytes if stored_val_bytes is None else stored_val_bytes
        return padded * stored + (n + m) * val_bytes
    raise ValueError(f"unknown fmt {fmt!r}")


def roofline_gflops(m: int, n: int, nnz: int, bandwidth_gbs: float,
                    **kw) -> float:
    """Bandwidth-bound GFLOP/s ceiling for this matrix/format."""
    b = bytes_moved(m, n, nnz, **kw)
    return FLOP_PER_NNZ * nnz / (b / (bandwidth_gbs * 1e9)) / 1e9
