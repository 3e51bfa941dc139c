"""spmv_tpu: a sparse matrix–vector multiplication framework in JAX.

Built from scratch in JAX/XLA with the capability set of the CPU
reference library DevilInChina/spmv (see SURVEY.md): a handle-based
inspect-once/execute-many SpMV API over CSR matrices, multiple execution
methods, SELL-C-σ and tiled formats, an auto-tuning inspector, Matrix Market
I/O with binary caching, a golden-oracle validation harness, and multi-chip
mesh execution.
"""

from .types import CsrMatrix, Method, VectorizedWay, METHOD_NAMES, VECTORIZED_NAMES
from .oracle import spmv_golden, rmse, max_abs_err
from .handle import (
    SpmvHandle,
    create_handle,
    spmv,
    spmv_create_handle_all_in_one,
    spmv_clear_handle,
    spmv_destroy_handle,
    spmv_destory_handle,
)
from .inspector import featurize, choose_method, tune, MatrixFeatures
from . import io, formats, ops, parallel, bench, solvers, utils

__version__ = "0.1.0"

__all__ = [
    "CsrMatrix", "Method", "VectorizedWay", "METHOD_NAMES", "VECTORIZED_NAMES",
    "spmv_golden", "rmse", "max_abs_err",
    "SpmvHandle", "create_handle", "spmv",
    "spmv_create_handle_all_in_one", "spmv_clear_handle",
    "spmv_destroy_handle", "spmv_destory_handle",
    "featurize", "choose_method", "tune", "MatrixFeatures",
    "solvers",
    "__version__",
]
