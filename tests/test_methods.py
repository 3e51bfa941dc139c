"""Every method × every matrix in the zoo × dtypes, vs the golden oracle.

The reference's only systematic check is its method sweep with RMSE gating
(test_spmv.c:237-245, :138-145); this is that sweep as a real test suite,
plus the exact-arithmetic gate its value fixture enables.
"""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import Method
from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden

METHODS = [
    Method.SERIAL,
    Method.PARALLEL,
    Method.BALANCED,
    Method.BALANCED2,
    Method.BALANCED_YID,
    Method.SELL_C_SIGMA,
    Method.CSR5,
    Method.AUTO,
]


#: the ``matrices`` fixture's keys, fixed here so that parametrization never
#: depends on anything computed at import
ZOO_NAMES = ["banded", "banded_rect", "uniform", "powerlaw", "empty_rows",
             "single_megarow", "tiny", "one_row", "one_col"]


def test_zoo_names_match_fixture(matrices):
    assert sorted(matrices) == sorted(ZOO_NAMES)


@pytest.mark.parametrize("name", ZOO_NAMES)
@pytest.mark.parametrize("method", METHODS)
def test_method_exact_arithmetic(matrices, method, name):
    """Dyadic values + x=1 → device f64 result must be bit-exact vs oracle
    (the reference's reproducibility trick, test_spmv.c:199-202)."""
    a = matrices[name]
    h = spmv_tpu.create_handle(a, method=method)
    x = generate.make_x(a.n, dtype=np.float64, kind="ones")
    y = np.asarray(spmv_tpu.spmv(h, x))
    g = spmv_golden(a, x)
    np.testing.assert_array_equal(y, g, err_msg=f"{name}/{method.name}")


@pytest.mark.parametrize("name", ZOO_NAMES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_method_random_values(matrices, method, dtype, name):
    a = matrices[name]
    rng = np.random.default_rng(ZOO_NAMES.index(name))
    a = spmv_tpu.CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                           rng.standard_normal(a.nnz).astype(dtype))
    h = spmv_tpu.create_handle(a, method=method)
    x = rng.standard_normal(a.n).astype(dtype)
    y = np.asarray(spmv_tpu.spmv(h, x))
    g = spmv_golden(a, x.astype(np.float64))
    tol = 1e-4 if dtype == np.float32 else 1e-10
    scale = max(np.abs(g).max(), 1.0)
    np.testing.assert_allclose(y, g, rtol=0, atol=tol * scale,
                               err_msg=f"{name}/{method.name}/{dtype}")


def test_handle_repeated_execution(matrices):
    a = matrices["uniform"]
    h = spmv_tpu.create_handle(a, method=Method.SELL_C_SIGMA)
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.standard_normal(a.n)
        np.testing.assert_allclose(np.asarray(spmv_tpu.spmv(h, x)),
                                   spmv_golden(a, x), atol=1e-10)


def test_handle_clear_and_destroy(matrices):
    a = matrices["tiny"]
    h = spmv_tpu.create_handle(a, method=Method.SERIAL)
    spmv_tpu.spmv_clear_handle(h)
    with pytest.raises(RuntimeError):
        spmv_tpu.spmv(h, np.zeros(a.n))
    # reference-parity alias exists, tolerates None
    spmv_tpu.spmv_destory_handle(None)
    spmv_tpu.spmv_destroy_handle(h)


def test_parity_constructor():
    a = generate.banded(50, 50, 2)
    h = spmv_tpu.spmv_create_handle_all_in_one(
        a.m, a.n, a.rowptr, a.colidx, a.vals,
        nthreads=8, method=Method.BALANCED, dtype=np.float64,
        mtx_token="banded50")
    x = np.ones(a.n)
    np.testing.assert_array_equal(np.asarray(spmv_tpu.spmv(h, x)),
                                  spmv_golden(a, x))
    assert h.mtx_token == "banded50"
    assert h.method_name == "Method_Balanced"


def test_x_shape_validation(matrices):
    a = matrices["banded_rect"]  # m != n
    h = spmv_tpu.create_handle(a, method=Method.SERIAL)
    with pytest.raises(ValueError):
        spmv_tpu.spmv(h, np.zeros(a.m))  # wrong: must be n-length


def test_bfloat16_storage():
    import jax.numpy as jnp
    import ml_dtypes
    a = generate.banded(256, 256, 3, dtype=np.float32)
    a16 = spmv_tpu.CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                             a.vals.astype(ml_dtypes.bfloat16))
    h = spmv_tpu.create_handle(a16, method=Method.SELL_C_SIGMA)
    x = np.ones(a.n, dtype=np.float32)
    y = np.asarray(spmv_tpu.spmv(h, x))
    assert y.dtype == np.float32  # f32 accumulation of bf16 storage
    np.testing.assert_array_equal(y, spmv_golden(a, x))  # dyadic-exact in bf16


def test_dia_method(matrices):
    import numpy as np
    from spmv_tpu import create_handle, spmv, Method
    from spmv_tpu.oracle import spmv_golden
    for name in ("banded", "banded_rect", "tiny"):
        a = matrices[name]
        h = create_handle(a, method=Method.DIA)
        x = np.random.default_rng(3).standard_normal(a.n)
        y = np.asarray(spmv(h, x))
        np.testing.assert_allclose(y, spmv_golden(a, x), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_auto_picks_dia_for_banded(matrices):
    from spmv_tpu import create_handle, Method
    h = create_handle(matrices["banded"], method=Method.AUTO)
    assert h.method == Method.DIA


def test_dia_profile():
    import numpy as np
    from spmv_tpu.io import generate
    from spmv_tpu.formats.dia import dia_profile, pack_dia
    a = generate.banded(100, 100, 2)
    nd, fill = dia_profile(a)
    assert nd == 5
    assert fill > 0.9
    d = pack_dia(a)
    assert d.data.shape == (5, 100)
    # round-trip: dense reconstruction matches
    dense = np.zeros((100, 100))
    for k, off in enumerate(d.offsets):
        idx = np.arange(max(0, -off), min(100, 100 - off))
        dense[idx, idx + off] = d.data[k, idx]
    np.testing.assert_array_equal(dense, a.to_dense())


def test_tune_picks_working_method(matrices):
    from spmv_tpu import tune, Method
    a = matrices["banded"]
    h, results = tune(a, methods=[Method.SERIAL, Method.DIA], iters=2,
                      repeats=1)
    assert h.method in (Method.SERIAL, Method.DIA)
    assert len(results) == 2
    import numpy as np
    from spmv_tpu import spmv
    from spmv_tpu.oracle import spmv_golden
    x = np.random.default_rng(0).standard_normal(a.n)
    np.testing.assert_allclose(np.asarray(spmv(h, x)), spmv_golden(a, x),
                               rtol=1e-10, atol=1e-12)


def test_handle_reorder_rcm(matrices):
    import numpy as np
    from spmv_tpu import create_handle, spmv, Method
    from spmv_tpu.oracle import spmv_golden
    # scrambled banded matrix; reorder="rcm" must give identical results
    from spmv_tpu.formats import reorder as rmod
    from spmv_tpu.io import generate
    a0 = generate.banded(256, 256, 3, seed=2)
    scramble = np.random.default_rng(1).permutation(256)
    a, _ = rmod.reorder_symmetric(a0, scramble)
    h = create_handle(a, method=Method.BALANCED, reorder="rcm")
    assert h.perm is not None
    x = np.random.default_rng(2).standard_normal(a.n)
    np.testing.assert_allclose(np.asarray(spmv(h, x)), spmv_golden(a, x),
                               rtol=1e-10, atol=1e-12)


def test_handle_reorder_rejects_rect():
    import pytest
    from spmv_tpu import create_handle, Method
    from spmv_tpu.io import generate
    a = generate.random_uniform(50, 70, 4, seed=1)
    with pytest.raises(ValueError):
        create_handle(a, method=Method.SERIAL, reorder="rcm")


def test_dia_lossless_bf16_gate():
    import numpy as np
    from spmv_tpu.io import generate
    from spmv_tpu.formats.dia import pack_dia, is_lossless_bf16
    a = generate.banded(500, 500, 2, dtype=np.float32, seed=1)  # dyadic k/8
    assert is_lossless_bf16(a.vals)
    import ml_dtypes
    assert pack_dia(a).data.dtype == ml_dtypes.bfloat16
    b = generate.banded(500, 500, 2, dtype=np.float32, seed=1, exact=False)
    assert not is_lossless_bf16(b.vals)
    assert pack_dia(b).data.dtype == np.float32
    # bf16-stored plan still matches the golden EXACTLY (values dyadic)
    from spmv_tpu import create_handle, spmv, Method
    from spmv_tpu.oracle import spmv_golden
    h = create_handle(a, method=Method.DIA)
    x = np.ones(a.n, np.float32)
    np.testing.assert_array_equal(np.asarray(spmv(h, x)),
                                  spmv_golden(a, x).astype(np.float32))


def test_bcsr_method():
    import numpy as np
    from spmv_tpu.io import generate
    from spmv_tpu import create_handle, spmv, Method
    from spmv_tpu.oracle import spmv_golden
    a = generate.block_random(6, 8, blocks_per_row=3, fill=0.4, seed=2)
    h = create_handle(a, method=Method.BCSR)
    x = np.random.default_rng(1).standard_normal(a.n)
    y = np.asarray(spmv(h, x))
    ref = spmv_golden(a, x)
    scale = max(abs(ref).max(), 1)
    np.testing.assert_allclose(y / scale, ref / scale, atol=1e-5)


def test_auto_picks_bcsr_for_blocky():
    from spmv_tpu.io import generate
    from spmv_tpu import create_handle, Method
    a = generate.block_random(4, 4, blocks_per_row=2, fill=0.5, seed=3)
    h = create_handle(a, method=Method.AUTO)
    assert h.method == Method.BCSR


def test_bcsr_profile_and_rect():
    import numpy as np
    from spmv_tpu.io import generate
    from spmv_tpu.formats.bcsr import bcsr_profile, pack_bcsr
    a = generate.block_random(3, 5, blocks_per_row=2, fill=0.3, seed=4)
    nb, fill = bcsr_profile(a)
    assert nb <= 6 and fill > 0.2
    b = pack_bcsr(a)
    # reconstruction
    dense = np.zeros((a.m, a.n), np.float32)
    for k in range(b.nblocks):
        r0, c0 = b.block_rows[k]*128, b.block_cols[k]*128
        dense[r0:r0+128, c0:c0+128] = b.blocks[k]
    np.testing.assert_allclose(dense, a.to_dense().astype(np.float32))


def test_bcsr_einsum_runs_at_highest_precision():
    """A default-precision f32 contraction may run in TF32 on a GPU; the
    BCSR plan must ask for HIGHEST."""
    import jax
    import jax.numpy as jnp
    from spmv_tpu.ops import xla_csr
    blocks = jnp.ones((2, 128, 128), jnp.float32)
    rows = jnp.array([0, 1], jnp.int32)
    cols = jnp.array([0, 0], jnp.int32)
    x = jnp.ones(128, jnp.float32)
    jaxpr = jax.make_jaxpr(lambda b, x: xla_csr.bcsr_spmv(
        b, rows, cols, x, m=256, nblock_rows=2))(blocks, x)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, jaxpr
    for e in dots:
        assert "HIGHEST" in str(e.params["precision"]), e.params


@pytest.mark.parametrize("kind,expected", [
    ("banded", Method.DIA),
    ("blocky", Method.BCSR),
    ("uniform", Method.SELL_C_SIGMA),
    ("powerlaw", Method.BALANCED),
])
def test_auto_routes_by_structure(kind, expected):
    """AUTO keeps only device-neutral features: diagonal fill, block fill,
    SELL padding, else the exact-nnz scan."""
    a = {
        "banded": lambda: generate.banded(20_000, 20_000, 3, seed=1),
        "blocky": lambda: generate.block_random(4, 4, blocks_per_row=2,
                                                fill=0.5, seed=3),
        "uniform": lambda: generate.random_uniform(20_000, 20_000, 40,
                                                   seed=4),
        "powerlaw": lambda: generate.power_law(20_000, 20_000, 400_000,
                                               seed=5),
    }[kind]()
    assert spmv_tpu.choose_method(a) == expected
    assert spmv_tpu.choose_method(a, spmv_tpu.featurize(a)) == expected
    h = spmv_tpu.create_handle(a, method=Method.AUTO)
    assert h.method == expected
    x = np.random.default_rng(6).standard_normal(a.n)
    np.testing.assert_allclose(np.asarray(spmv_tpu.spmv(h, x)),
                               spmv_golden(a, x), rtol=1e-10, atol=1e-10)
