"""Mega-row matrices through the AUTO handle.

The reference handles mega-rows with Balanced2's row-redistribution +
intra-row split (parallel_balanced2_spmv.c:115-198); here AUTO routes them
to the exact-nnz scan, whose tiles split any row.
"""

import numpy as np
import pytest

from spmv_tpu import Method, create_handle, spmv
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_handle_powerlaw_megarows(dtype):
    a = generate.power_law(3000, 3000, 40 * 3000, dtype=dtype, seed=2)
    assert a.row_lengths.max() > 8 * (-(-a.n // 1024))  # fixture has megas
    h = create_handle(a, method=Method.AUTO)
    x = np.random.default_rng(3).standard_normal(a.n).astype(dtype)
    y = np.asarray(spmv(h, x))
    g = spmv_golden(a, x)
    tol = 2e-5 if dtype == np.float32 else 1e-10
    assert np.abs(y - g).max() / max(np.abs(g).max(), 1) < tol
