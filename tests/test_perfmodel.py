"""The traffic model: the reference's CSR formula, and DIA at the stored
width with x and y moved once."""

import pytest

from spmv_tpu.utils.perfmodel import bytes_moved, roofline_gflops


def test_csr_is_reference_formula():
    m, n, nnz = 10, 12, 30
    assert bytes_moved(m, n, nnz) == (m + 1 + nnz) * 4 + (2 * nnz + m) * 4
    assert bytes_moved(m, n, nnz, val_bytes=8) == \
        (m + 1 + nnz) * 4 + (2 * nnz + m) * 8


@pytest.mark.parametrize("stored,val", [(2, 4), (4, 4), (8, 8), (None, 8)])
def test_dia_counts_stored_width(stored, val):
    m, n, ndiags = 1000, 1200, 5
    nnz = 4000
    b = bytes_moved(m, n, nnz, val_bytes=val, fmt="dia",
                    pad_ratio=ndiags * m / nnz, stored_val_bytes=stored)
    assert b == ndiags * m * (stored or val) + (n + m) * val


def test_unknown_format_and_roofline():
    with pytest.raises(ValueError, match="unknown fmt"):
        bytes_moved(1, 1, 1, fmt="ell")
    # 2 flops per nnz, at the bandwidth (GB/s) over the bytes moved
    g = roofline_gflops(100, 100, 1000, 1000.0)
    assert g == pytest.approx(2 * 1000 * 1000.0 / bytes_moved(100, 100, 1000))
