"""bench_compare.py on the CPU at small sizes: the per-plan bytes model,
the suite rows it reads, and the barrier switch.  Its timings and traces
mean something only on a GPU."""

import os

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def cmp(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import bench_compare
    return bench_compare


def test_model_bytes_dia_uses_stored_width(cmp):
    """Dyadic banded values are stored as bf16 diagonals: the DIA model
    counts 2 B per stored slot, x once and y once."""
    from spmv_tpu import Method, create_handle
    from spmv_tpu.io import generate
    a = generate.banded(1000, 1000, 2, dtype=np.float32, seed=7)
    h = create_handle(a, method=Method.DIA)
    model, b = cmp.model_bytes(a, h)
    ndiags = h.plan["data"].shape[0]
    assert model == "dia" and str(h.plan["data"].dtype) == "bfloat16"
    assert b == ndiags * a.m * 2 + (a.n + a.m) * 4
    # under the CSR model the same matrix moves more bytes
    assert cmp.model_bytes(a)[1] > b


@pytest.mark.parametrize("method", ["SERIAL", "SELL_C_SIGMA", "BALANCED"])
def test_model_bytes_csr_like(cmp, method):
    from spmv_tpu import Method, create_handle
    from spmv_tpu.io import generate
    from spmv_tpu.utils.perfmodel import bytes_moved
    a = generate.random_uniform(400, 400, 5, dtype=np.float64, seed=1)
    h = create_handle(a, method=Method[method])
    assert cmp.model_bytes(a, h) == ("csr", bytes_moved(
        a.m, a.n, a.nnz, val_bytes=8))


def test_suite_rows_raise_on_failure(cmp, monkeypatch):
    from spmv_tpu import Method
    from spmv_tpu.io import generate
    a = generate.random_uniform(200, 200, 4, dtype=np.float32, seed=2)
    (row,) = cmp._suite_rows("u", a, [Method.SERIAL])
    assert row[cmp._METHOD] == "Method_Serial" and float(row[cmp._AVG_MS]) > 0
    # a matrix with no diagonal structure refuses DIA: the suite prints a
    # '#' line and skips the row, which the comparison must not hide
    with pytest.raises(RuntimeError, match="DIA unprofitable"):
        cmp._suite_rows("u", a, [Method.DIA])


def test_no_barriers_restores(cmp):
    import jax
    saved = jax.lax.optimization_barrier
    with cmp._no_barriers():
        assert jax.lax.optimization_barrier(3) == 3
        assert jax.lax.optimization_barrier is not saved
    assert jax.lax.optimization_barrier is saved


def test_compare_refuses_cpu(cmp, tmp_path):
    with pytest.raises(RuntimeError, match="GPU is required"):
        cmp.main(["--out", str(tmp_path / "c.json")])
