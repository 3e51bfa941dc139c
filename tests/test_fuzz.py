"""Property-style fuzz: random CSR structures × every method vs the oracle.

SURVEY.md §4 calls for property tests over the edge cases the reference's
method family exists to handle (empty rows, mega-rows, m≠n).  Seeded, not
hypothesis-based — deterministic in CI.
"""

import numpy as np
import pytest

from spmv_tpu.types import CsrMatrix, Method
from spmv_tpu import create_handle, spmv
from spmv_tpu.oracle import spmv_golden

METHODS = [Method.SERIAL, Method.PARALLEL, Method.BALANCED,
           Method.BALANCED2, Method.BALANCED_YID, Method.SELL_C_SIGMA,
           Method.CSR5, Method.AUTO]


def random_csr(rng):
    m = int(rng.integers(1, 400))
    n = int(rng.integers(1, 400))
    density_mode = rng.integers(0, 4)
    if density_mode == 0:          # very sparse + empty rows
        nnz = int(rng.integers(0, m + 1))
    elif density_mode == 1:        # a mega-row
        nnz = int(rng.integers(n, 3 * n + 1))
    else:
        nnz = int(rng.integers(0, min(m * n, 5000)))
    rows = rng.integers(0, m, size=nnz)
    if density_mode == 1 and nnz:
        rows[: nnz // 2] = int(rng.integers(0, m))   # concentrate
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz)
    return CsrMatrix.from_coo(m, n, rows.astype(np.int32),
                              cols.astype(np.int32), vals)


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_all_methods(seed):
    rng = np.random.default_rng(1000 + seed)
    a = random_csr(rng)
    x = rng.standard_normal(a.n)
    ref = spmv_golden(a, x)
    scale = max(np.abs(ref).max(), 1.0)
    for method in METHODS:
        h = create_handle(a, method=method)
        y = np.asarray(spmv(h, x))
        np.testing.assert_allclose(
            y / scale, ref / scale, atol=1e-10,
            err_msg=f"seed={seed} m={a.m} n={a.n} nnz={a.nnz} "
                    f"method={h.method_name}")
