"""Native (C++) vs pure-Python parity — both paths must produce identical
results.

The native MatrixMarket parser (native/spmv_native.cpp) mirrors the Python
one; these tests run BOTH paths on the same inputs and compare outputs, so
CI exercises the Python fallback even on machines where the native .so
builds.
"""

import numpy as np
import pytest

from spmv_tpu.io import generate
from spmv_tpu.native import native_available


@pytest.mark.skipif(not native_available(), reason="native lib unavailable")
class TestNativeParity:
    def test_mtx_parse_parity(self, tmp_path):
        from spmv_tpu.io.mmio import read_mtx, write_mtx
        a = generate.random_uniform(40, 30, 5, dtype=np.float64, seed=11)
        path = str(tmp_path / "t.mtx")
        write_mtx(path, a)
        an = read_mtx(path, use_native=True)
        ap = read_mtx(path, use_native=False)
        np.testing.assert_array_equal(an.rowptr, ap.rowptr)
        np.testing.assert_array_equal(an.colidx, ap.colidx)
        np.testing.assert_allclose(an.vals, ap.vals, rtol=0, atol=0)

    def test_mtx_parse_parity_symmetric_pattern(self, tmp_path):
        path = str(tmp_path / "sym.mtx")
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate pattern symmetric\n")
            f.write("% comment line\n4 4 5\n1 1\n2 1\n3 2\n4 4\n4 1\n")
        from spmv_tpu.io.mmio import read_mtx
        an = read_mtx(path, use_native=True)
        ap = read_mtx(path, use_native=False)
        np.testing.assert_array_equal(an.rowptr, ap.rowptr)
        np.testing.assert_array_equal(an.colidx, ap.colidx)
        np.testing.assert_allclose(an.vals, ap.vals)
