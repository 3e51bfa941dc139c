"""Test configuration: the CPU backend with an 8-device virtual mesh.

Tests need no accelerator — multi-device sharding is validated on a
simulated mesh exactly as SURVEY.md §4 prescribes; the driver's
``__graft_entry__.dryrun_multichip`` does the same.  ``JAX_PLATFORMS``
defaults to ``cpu``; tests marked ``gpu`` run on a card when it is left to
JAX (``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``) and skip
otherwise, deciding in the ``gpu_device`` fixture.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from spmv_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from spmv_tpu.io import generate  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided at run time)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("no GPU visible to JAX")
    return gpus[0]


@pytest.fixture(scope="session")
def matrices():
    """The structural zoo from SURVEY.md §7: every edge case the reference's
    method family exists to handle."""
    zoo = {
        "banded": generate.banded(300, 300, 4),
        "banded_rect": generate.banded(200, 350, 3),
        "uniform": generate.random_uniform(500, 400, 9, seed=1),
        "powerlaw": generate.power_law(600, 600, 12_000, seed=2),
        "empty_rows": generate.with_empty_rows(
            generate.random_uniform(400, 300, 6, seed=3), 0.4),
        "single_megarow": _single_megarow(),
        "tiny": generate.banded(3, 3, 1),
        "one_row": generate.random_uniform(1, 500, 300, seed=4),
        "one_col": generate.random_uniform(500, 1, 1, seed=5),
    }
    return zoo


def _single_megarow():
    m, n = 200, 1000
    rng = np.random.default_rng(7)
    rows = np.concatenate([
        np.zeros(5000, dtype=np.int32),
        rng.integers(1, m, size=800).astype(np.int32),
    ])
    cols = rng.integers(0, n, size=rows.size).astype(np.int32)
    vals = generate.exact_values(rng, rows.size)
    from spmv_tpu.types import CsrMatrix
    return CsrMatrix.from_coo(m, n, rows, cols, vals)
