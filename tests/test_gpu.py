"""Checks that need a GPU; they skip elsewhere (the ``gpu_device`` fixture
decides at run time).  Run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

from spmv_tpu import Method, create_handle, spmv
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden


@pytest.mark.gpu
def test_bcsr_f32_is_not_tf32(gpu_device):
    """TF32 keeps 10 mantissa bits; an f32 block product at full precision
    stays within 1e-6 of the oracle, TF32 would miss it by ~1e-3."""
    a = generate.block_random(16, 16, blocks_per_row=4, fill=0.5,
                              dtype=np.float32, seed=1)
    a = a.astype(np.float32)
    x = np.random.default_rng(2).standard_normal(a.n).astype(np.float32)
    h = create_handle(a, method=Method.BCSR)
    y = np.asarray(spmv(h, x))
    g = spmv_golden(a, x.astype(np.float64))
    assert list(spmv(h, x).devices())[0].platform == "gpu"
    assert np.abs(y - g).max() <= 1e-5 * max(np.abs(g).max(), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("method", [Method.SERIAL, Method.SELL_C_SIGMA,
                                    Method.BALANCED, Method.DIA])
def test_exact_on_gpu(gpu_device, method):
    a = generate.banded(50_000, 50_000, 3, dtype=np.float64, seed=3)
    h = create_handle(a, method=method)
    x = np.ones(a.n)
    np.testing.assert_array_equal(np.asarray(spmv(h, x)), spmv_golden(a, x))
