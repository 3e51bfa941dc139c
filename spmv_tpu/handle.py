"""Handle lifecycle + method dispatch — the framework core.

Re-design of the reference's L3/L4 (``src/src_spmv/common.c``,
``include/spmv.h``): ``spmv_create_handle_all_in_one`` runs the *inspector*
(format conversion + partition planning, all host-side numpy), places the
resulting static-shape arrays on device, and binds a jitted executable;
``spmv`` is then a pure device call, any number of times — the same
inspect-once/execute-many contract as the reference (include/spmv.h:41-71).

Method → execution-plan mapping (each is a genuinely distinct program, not a
renamed copy — see SURVEY.md §2.3):

=================  ==========================================================
Method_Serial      gather + sorted segment-sum (the naive jnp program)
Method_Parallel    chunked ELL slices in natural order (sell machinery, σ=1)
Method_Balanced    two-level equal-nnz tile scan + carry scan
Method_Balanced2   equal-nnz tile scan, tile sized for mega-row splitting
Method_BalancedYid single global prefix scan (exact-nnz split, zero fix-ups)
Method_SellCSigma  chunked SELL-C-σ (σ-sorted 128-row slices)
Method_Csr5Spmv    equal-nnz tiled scan (CSR5's tile + calibrator role)
Method_Dia         banded shifted-stream FMAs (zero gathers)
Method_Bcsr        128×128 dense blocks via batched matrix-vector products
Method_Auto        inspector picks one of the above from matrix features
=================  ==========================================================
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .types import CsrMatrix, Method, VectorizedWay, METHOD_NAMES, INT_DTYPE
from .formats import partition, sell as sell_fmt, dia as dia_fmt
from .ops import xla_csr

__all__ = [
    "SpmvHandle",
    "create_handle",
    "spmv",
    "spmv_create_handle_all_in_one",
    "spmv_clear_handle",
    "spmv_destory_handle",
    "spmv_destroy_handle",
]


def _ensure_x64_if_needed(dtype) -> None:
    if np.dtype(dtype) == np.float64 and not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


def _acc_dtype(dtype) -> Any:
    """Accumulation dtype: bf16 storage accumulates in f32."""
    if dtype == jnp.bfloat16:
        return jnp.float32
    return dtype


# --------------------------------------------------------------------------
# Jitted executables (module-level so the XLA compile cache is shared across
# handles with identical shapes — the reference re-preps per handle instead).
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("m",))
def _exec_serial(rows, colidx, vals, x, m):
    acc = _acc_dtype(vals.dtype)
    return xla_csr.segment_sum_spmv(rows, colidx, vals.astype(acc),
                                    x.astype(acc), m=m)



@jax.jit
def _exec_scan_global(colidx_pad, vals_pad, row_start, row_end, x):
    acc = _acc_dtype(vals_pad.dtype)
    return xla_csr.scan_spmv_global(colidx_pad, vals_pad.astype(acc),
                                    row_start, row_end, x.astype(acc))


@functools.partial(jax.jit, static_argnames=("tile",))
def _exec_scan_tiled(colidx_pad, vals_pad, row_start, row_end, x, tile):
    acc = _acc_dtype(vals_pad.dtype)
    return xla_csr.scan_spmv_tiled(colidx_pad, vals_pad.astype(acc),
                                   row_start, row_end, x.astype(acc),
                                   tile=tile)


@functools.partial(jax.jit, static_argnames=("tile",))
def _exec_balanced2(colidx_pad, vals_pad, vrow_start, vrow_end,
                    sub_start, sub_end, x, tile):
    acc = _acc_dtype(vals_pad.dtype)
    return xla_csr.balanced2_spmv(colidx_pad, vals_pad.astype(acc),
                                  vrow_start, vrow_end, sub_start, sub_end,
                                  x.astype(acc), tile=tile)


@functools.partial(jax.jit, static_argnames=("m", "nblock_rows"))
def _exec_bcsr(blocks, block_rows, block_cols, x, m, nblock_rows):
    # bf16 blocks (lossless compression) keep x and accumulation in f32
    x_t = jnp.float32 if blocks.dtype == jnp.bfloat16 else blocks.dtype
    return xla_csr.bcsr_spmv(blocks, block_rows, block_cols,
                             x.astype(x_t), m=m,
                             nblock_rows=nblock_rows)


@functools.partial(jax.jit, static_argnames=("offsets", "m", "n"))
def _exec_dia(data, x, offsets, m, n):
    acc = _acc_dtype(data.dtype)
    return xla_csr.dia_spmv(data.astype(acc), x.astype(acc),
                            offsets=offsets, m=m, n=n)


@functools.partial(jax.jit, static_argnames=("nslices", "identity_order"))
def _exec_sell(cols, vals, chunk_ids, inv_pos, x, nslices, identity_order):
    acc = _acc_dtype(vals.dtype)
    return xla_csr.sell_spmv(cols, vals.astype(acc), chunk_ids, inv_pos,
                             x.astype(acc), nslices=nslices,
                             identity_order=identity_order)


# --------------------------------------------------------------------------
# Handle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpmvHandle:
    """Inspect-once/execute-many handle (reference ``spmv_Handle``,
    spmv_Defines.h:44-68)."""

    method: Method               # resolved (AUTO → concrete)
    requested_method: Method
    dtype: np.dtype
    m: int
    n: int
    nnz: int
    nthreads: int                # parity knob; informs tile-count choices
    vectorized: VectorizedWay
    mtx_token: Optional[str]
    plan: Dict[str, Any]         # device arrays + static config
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _cleared: bool = False
    _bound: Any = None           # plan-bound executable (x -> y), built once
    perm: Any = None             # reorder permutation (None if not reordered)
    _matrix: Any = None          # host CsrMatrix, pre-reorder (kept until destroy)
    _reorder: Optional[str] = None  # reorder kind requested at create

    def __call__(self, x) -> jax.Array:
        return spmv(self, x)

    def block_until_ready(self, y):
        return jax.block_until_ready(y)

    @property
    def method_name(self) -> str:
        return METHOD_NAMES[self.method]

    def __repr__(self) -> str:
        extra = (f", fallback={self.plan['sell_fallback']}"
                 if "sell_fallback" in self.plan else "")
        return (f"SpmvHandle({self.method_name}, {self.m}x{self.n}, "
                f"nnz={self.nnz}, dtype={np.dtype(self.dtype).name}"
                f"{extra})")

    def clear(self) -> None:
        """Drop device buffers + per-method prep, keep the handle reusable.

        Reference parity: ``spmv_clear_handle`` frees every per-method extra
        handle but keeps the CSR matrix, so the handle can be re-prepped with
        another method (common.c:31-41).  Use :meth:`prepare` to re-prep;
        ``destroy`` additionally drops the matrix and ends the lifecycle.
        """
        self.plan = {}
        self._bound = None

    def prepare(self, method: Optional[Method] = None) -> "SpmvHandle":
        """Re-prep a cleared handle on its retained matrix (reference flow:
        clear + per-method ``*_get_handle``, common.c:31-41, :161-188)."""
        if self._cleared or self._matrix is None:
            raise RuntimeError("handle was destroyed; create a new one")
        req = Method(method) if method is not None else self.requested_method
        fresh = create_handle(self._matrix, method=req,
                              nthreads=self.nthreads,
                              vectorized=self.vectorized,
                              mtx_token=self.mtx_token,
                              reorder=self._reorder)
        self.method = fresh.method
        self.requested_method = req
        self.plan = fresh.plan
        self._bound = fresh._bound
        self.perm = fresh.perm
        return self

    def destroy(self) -> None:
        """End the lifecycle (reference spmv_destory_handle, spmv.h:19)."""
        self.clear()
        self._matrix = None
        self._cleared = True


# --------------------------------------------------------------------------
# Plan builders (host-side inspection — reference *_get_handle functions)
# --------------------------------------------------------------------------

def _tile_for(nnz: int, nthreads: int, method: Method) -> int:
    """Pick the equal-nnz tile length.

    Mirrors the *intent* of the reference's per-thread quantile stride
    ceil(nnz/T) (parallel_balanced_spmv.c:41): enough tiles to saturate the
    machine, tiles long enough to amortize the carry pass.  Balanced2 uses
    shorter tiles so mega-rows split across more tiles.  ``nthreads`` plays
    its reference role as the requested parallelism degree: when given, the
    plan aims for at least that many tiles (each "thread" an equal-nnz
    tile), like the reference's ceil(nnz/T) stride yields T chunks — best
    effort only: tiles never shrink below 256 nnz, so matrices with
    nnz < 256·min_tiles get fewer.

    The 4096/1024 base lengths were tuned on the previous accelerator and
    are untuned on the H100 (an open measurement, ROADMAP.md).
    """
    base = 4096 if method == Method.BALANCED else 1024
    min_tiles = max(64, nthreads)
    while base > 256 and nnz // base < min_tiles:
        base //= 2
    return base


# re-exported for the existing API surface (bench.py, bench/suite.py)
from .utils.profiling import predeal_profile  # noqa: F401  (re-export)
from .utils.profiling import dev_put as _dev_put


def _build_plan(a: CsrMatrix, method: Method,
                nthreads: int) -> Dict[str, Any]:
    dev = _dev_put
    if method == Method.SERIAL:
        return {
            "rows": dev(partition.row_ids(a)),
            "colidx": dev(a.colidx),
            "vals": dev(a.vals),
        }
    if method == Method.BALANCED2:
        # Distinct mega-row split algorithm; demotes to Balanced when no
        # mega-row exists — the reference's rule
        # (parallel_balanced2_spmv.c:87-90), surfaced via requested_method.
        tile = _tile_for(a.nnz, nthreads, method)
        b2 = partition.build_balanced2_plan(a, tile=tile)
        if b2 is None:
            plan = _build_plan(a, Method.BALANCED, nthreads)
            plan["demoted"] = True
            return plan
        return {
            "tile": b2.inner.tile,
            "colidx_pad": dev(b2.inner.colidx_pad),
            "vals_pad": dev(b2.inner.vals_pad),
            "vrow_start": dev(b2.inner.row_start),
            "vrow_end": dev(b2.inner.row_end),
            "sub_start": dev(b2.sub_ptr_start),
            "sub_end": dev(b2.sub_ptr_end),
            "m_virtual": b2.m_virtual,
            "n_mega_rows": b2.n_mega_rows,
        }
    if method in (Method.BALANCED, Method.BALANCED_YID, Method.CSR5):
        tile = _tile_for(a.nnz, nthreads, method)
        p = partition.build_tile_scan_plan(a, tile=tile)
        return {
            "tile": p.tile,
            "colidx_pad": dev(p.colidx_pad),
            "vals_pad": dev(p.vals_pad),
            "row_start": dev(p.row_start),
            "row_end": dev(p.row_end),
        }
    if method == Method.BCSR:
        from .formats import bcsr as bcsr_fmt
        nblocks, fill = bcsr_fmt.bcsr_profile(a)
        if a.nnz and (fill < 0.02
                      or nblocks * bcsr_fmt.BLOCK ** 2 * 8 > 4e9):
            raise ValueError(
                f"BCSR unprofitable: {nblocks} blocks at fill {fill:.4f} "
                f"(densification would allocate "
                f"{nblocks * bcsr_fmt.BLOCK**2 * 4 / 1e9:.1f}+ GB)")
        b = bcsr_fmt.pack_bcsr(a)
        return {
            "blocks": dev(b.blocks),
            "block_rows": dev(b.block_rows),
            "block_cols": dev(b.block_cols),
            "nblock_rows": -(-a.m // bcsr_fmt.BLOCK),
            "fill": b.fill,
        }
    if method == Method.DIA:
        ndiags, fill = dia_fmt.dia_profile(a)
        if a.nnz and (fill < 0.02 or ndiags > 4096):
            raise ValueError(
                f"DIA unprofitable: {ndiags} diagonals at fill {fill:.3f} "
                f"(would stream {ndiags * a.m * 4 / 1e6:.0f} MB per exec)")
        d = dia_fmt.pack_dia(a)
        data = d.data
        if np.dtype(data.dtype) == np.float32:
            # lossless bf16 diagonals halve the dominant stream;
            # _exec_dia upcasts
            import ml_dtypes
            dbf = data.astype(ml_dtypes.bfloat16)
            if np.array_equal(dbf.astype(np.float32), data):
                data = dbf
        return {
            "data": dev(data),
            "offsets": tuple(int(o) for o in d.offsets),
            "n": a.n,
            "fill": d.fill,
        }
    if method in (Method.PARALLEL, Method.SELL_C_SIGMA):
        sigma = 1 if method == Method.PARALLEL else 32 * sell_fmt.LANES
        # Mega-row matrices explode chunked-ELL padding (depth = slice max
        # row).  Estimate first and fall back to the tiled scan — the reference
        # eats the same explosion (its σ-sort can't fix a mega-row either).
        from .inspector import _sell_pad_ratio
        if a.nnz and _sell_pad_ratio(a.row_lengths.astype(np.int64),
                                     sigma=max(sigma, 1)) > 8.0:
            plan = _build_plan(a, Method.BALANCED, nthreads)
            plan["sell_fallback"] = "scan"
            return plan
        s = sell_fmt.pack_sell(a, sigma=sigma)
        return {
            "cols": dev(s.cols),
            "vals": dev(s.vals),
            "chunk_ids": dev(s.chunk_ids),
            "inv_pos": dev(s.inv_pos),
            "nslices": s.nslices,
            "identity_order": s.identity_order,
            "padded_nnz": s.padded_nnz,
        }
    raise ValueError(f"no plan builder for {method}")


def _make_bound(method: Method, plan: Dict[str, Any], m_rows: int):
    """Bind the plan's device arrays into a lean ``x -> y`` closure.

    One dict-lookup-free call path per handle: per-call Python work is just
    the jit dispatch of the pre-bound argument list.
    """
    p = plan
    m = method
    if m == Method.SERIAL:
        return lambda x: _exec_serial(p["rows"], p["colidx"], p["vals"], x,
                                      m_rows)
    if m == Method.BALANCED_YID:
        return lambda x: _exec_scan_global(p["colidx_pad"], p["vals_pad"],
                                           p["row_start"], p["row_end"], x)
    if m == Method.BALANCED2 and "sub_start" in p:
        return lambda x: _exec_balanced2(p["colidx_pad"], p["vals_pad"],
                                         p["vrow_start"], p["vrow_end"],
                                         p["sub_start"], p["sub_end"], x,
                                         p["tile"])
    if m in (Method.BALANCED, Method.BALANCED2, Method.CSR5):
        return lambda x: _exec_scan_tiled(p["colidx_pad"], p["vals_pad"],
                                          p["row_start"], p["row_end"], x,
                                          p["tile"])
    if m in (Method.PARALLEL, Method.SELL_C_SIGMA):
        if "sell_fallback" in p:      # mega-row pad explosion → tiled scan
            return lambda x: _exec_scan_tiled(p["colidx_pad"],
                                              p["vals_pad"], p["row_start"],
                                              p["row_end"], x, p["tile"])
        return lambda x: _exec_sell(p["cols"], p["vals"], p["chunk_ids"],
                                    p["inv_pos"], x, p["nslices"],
                                    p["identity_order"])
    if m == Method.DIA:
        return lambda x: _exec_dia(p["data"], x, p["offsets"], m_rows,
                                   p["n"])
    if m == Method.BCSR:
        return lambda x: _exec_bcsr(p["blocks"], p["block_rows"],
                                    p["block_cols"], x, m_rows,
                                    p["nblock_rows"])
    raise ValueError(f"unknown method {m}")


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def create_handle(a: CsrMatrix,
                  method: Method = Method.AUTO,
                  nthreads: int = 0,
                  vectorized: VectorizedWay = VectorizedWay.VPU,
                  mtx_token: Optional[str] = None,
                  reorder: Optional[str] = None,
                  warm: bool = False) -> SpmvHandle:
    """Inspect the matrix, build the plan, place it on device.

    The pythonic form of the reference's 11-argument
    ``spmv_create_handle_all_in_one`` (include/spmv.h:41-52).

    ``reorder``: optional locality pass before planning — "rcm" (bandwidth
    reduction), "window" (column clustering) or "cluster" (label-propagation
    community clustering, the METIS k-way role), square matrices only.  This
    is the reference's OPT_LEVEL=3 METIS stage (common.c:144-156) made a
    first-class option; unlike the reference (whose HARNESS permutes x/y,
    test_spmv.c:95-101), the handle does both permutations internally so the
    user-visible contract is unchanged.  The permutation is cached on disk
    when ``mtx_token`` is given, keyed like the reference's partition cache.
    For hot loops, pre-permute x yourself and use ``handle.perm`` directly.
    """
    _ensure_x64_if_needed(a.dtype)
    requested = Method(method)
    a_orig = a
    perm = None
    if reorder is not None:
        from .formats import reorder as reorder_mod
        if a.m != a.n:
            raise ValueError("reorder requires a square matrix")
        if mtx_token:
            perm = reorder_mod.cached_order(a, mtx_token, kind=reorder)
        elif reorder == "rcm":
            perm = reorder_mod.rcm_order(a)
        elif reorder == "window":
            perm = reorder_mod.window_cluster_order(a)
        elif reorder == "cluster":
            perm = reorder_mod.cluster_order(a)
        elif reorder == "length":
            perm = reorder_mod.length_order(a)
        else:
            raise ValueError(f"unknown reorder kind {reorder!r}")
        a, _ = reorder_mod.reorder_symmetric(a, perm)
    resolved = requested
    if requested == Method.AUTO:
        from .inspector import choose_method
        resolved = choose_method(a)
    if (VectorizedWay(vectorized) == VectorizedWay.MXU
            and resolved in (Method.PARALLEL, Method.SELL_C_SIGMA,
                             Method.CSR5) and a.nnz > 0):
        # MXU = route the reduction through dense blocks where the
        # structure permits: the BCSR batched-product plan (the reference's
        # widest-SIMD slot, VECTOR_AVX512 — which its dispatch never honors;
        # here the knob is real).  Falls through to the per-nonzero plans
        # when the matrix has no dense 128x128 block structure worth
        # densifying.
        # Like the Balanced2 demotion, requested_method records the ask.
        from .formats import bcsr as bcsr_fmt
        nblocks, fill = bcsr_fmt.bcsr_profile(a)
        if fill >= 0.02 and nblocks * bcsr_fmt.BLOCK ** 2 * 8 <= 4e9:
            resolved = Method.BCSR
    plan = _build_plan(a, resolved, nthreads)
    if plan.pop("demoted", False):
        resolved = Method.BALANCED    # reference's balanced2 demotion rule
    bound = _make_bound(resolved, plan, a.m)
    if perm is not None:
        perm_dev = _dev_put(jnp.asarray(perm.astype(INT_DTYPE)))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        inv_dev = _dev_put(jnp.asarray(inv.astype(INT_DTYPE)))
        inner = bound
        # y[perm[i]] = y'[i]  ⇔  y = y'[inv]
        bound = lambda x: inner(x[perm_dev])[inv_dev]
    h = SpmvHandle(
        method=resolved, requested_method=requested,
        dtype=np.dtype(a.dtype) if a.dtype != jnp.bfloat16 else a.dtype,
        m=a.m, n=a.n, nnz=a.nnz, nthreads=nthreads,
        vectorized=VectorizedWay(vectorized), mtx_token=mtx_token, plan=plan,
        _bound=bound, _matrix=a_orig, _reorder=reorder,
    )
    h.perm = perm
    if warm:
        x = jnp.zeros(a.n, dtype=a.vals.dtype)
        jax.block_until_ready(spmv(h, x))
    return h


def spmv(handle: SpmvHandle, x) -> jax.Array:
    """Execute y = A @ x (reference ``spmv``, include/spmv.h:65-71).

    Unlike the reference, the matrix lives in the handle (device-resident);
    only x flows in per call.
    """
    if handle._bound is None:
        raise RuntimeError("handle was cleared/destroyed; create a new one")
    if not isinstance(x, jax.Array):
        x = jnp.asarray(x)
    if x.shape != (handle.n,):
        raise ValueError(f"x has shape {x.shape}, expected ({handle.n},)")
    return handle._bound(x)


# -- reference-parity spellings ---------------------------------------------

def spmv_create_handle_all_in_one(m: int, n: int, rowptr, colidx, vals,
                                  nthreads: int = 0,
                                  method: Method = Method.AUTO,
                                  dtype=None,
                                  vectorized: VectorizedWay = VectorizedWay.VPU,
                                  mtx_token: Optional[str] = None) -> SpmvHandle:
    """Raw-array parity constructor (include/spmv.h:41-52)."""
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    a = CsrMatrix(m, n, rowptr, colidx, vals)
    return create_handle(a, method=method, nthreads=nthreads,
                         vectorized=vectorized, mtx_token=mtx_token)


def spmv_clear_handle(handle: SpmvHandle) -> None:
    if handle is not None:
        handle.clear()


def spmv_destroy_handle(handle: SpmvHandle) -> None:
    if handle is not None:
        handle.destroy()


#: the reference spells it "destory" (include/spmv.h:19) — keep the alias
spmv_destory_handle = spmv_destroy_handle
