"""Matrix inspector / auto-tuner.

The reference README promises "Matrix inspect and choose best method to run"
but ships an empty section (README.md:222-223).  This module implements it:
featurize the matrix on the host and pick the execution plan, encoding both
the reference's hard routing rules (CSR5-with-float falls back to SELL,
common.c:174-181; balanced2 demotes to balanced when there are no mega-rows,
parallel_balanced2_spmv.c:87-90) and structural rules that hold on any
device: a banded matrix needs no index stream, a block-dense one needs one
index per block, and SELL's padding is paid in bytes on every call.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import CsrMatrix, Method

__all__ = ["MatrixFeatures", "featurize", "choose_method", "tune"]


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    m: int
    n: int
    nnz: int
    mean_row: float
    std_row: float
    max_row: int
    empty_frac: float
    # Padding overhead if packed as chunked SELL-C-σ (C=128, depth mult-of-8):
    sell_pad_ratio: float
    # Diagonal structure: distinct (col-row) offsets and nnz/(ndiags·m) fill
    ndiags: int = 0
    dia_fill: float = 0.0
    # Block structure: nonempty 128x128 blocks and their mean fill
    nblocks: int = 0
    block_fill: float = 0.0

    @property
    def cv_row(self) -> float:
        return self.std_row / self.mean_row if self.mean_row > 0 else 0.0


def _sell_pad_ratio(lengths: np.ndarray, c: int = 128,
                    sigma: int = 32 * 128, sub: int = 8) -> float:
    """Estimate padded_nnz / nnz for chunked SELL packing without building it."""
    m_pad = max(-(-len(lengths) // c) * c, c)
    lens = np.zeros(m_pad, dtype=np.int64)
    lens[: len(lengths)] = lengths
    grid = -(-m_pad // sigma) * sigma
    lw = np.full(grid, 0, dtype=np.int64)
    lw[:m_pad] = lens
    win = np.sort(lw.reshape(-1, sigma), axis=1)[:, ::-1].reshape(-1)[:m_pad]
    depth = win.reshape(-1, c).max(axis=1)
    padded = np.maximum(-(-depth // sub) * sub, sub)
    total = int((padded * c).sum())
    nnz = int(lens.sum())
    return total / max(nnz, 1)


def featurize(a: CsrMatrix) -> MatrixFeatures:
    from .formats.bcsr import bcsr_profile
    from .formats.dia import dia_profile
    lengths = a.row_lengths.astype(np.int64)
    mean = float(lengths.mean()) if a.m else 0.0
    ndiags, dia_fill = dia_profile(a) if a.nnz else (0, 0.0)
    nblocks, block_fill = bcsr_profile(a) if a.nnz else (0, 0.0)
    return MatrixFeatures(
        m=a.m, n=a.n, nnz=a.nnz,
        mean_row=mean,
        std_row=float(lengths.std()) if a.m else 0.0,
        max_row=int(lengths.max()) if a.m else 0,
        empty_frac=float((lengths == 0).mean()) if a.m else 0.0,
        sell_pad_ratio=_sell_pad_ratio(lengths) if a.m else 1.0,
        ndiags=ndiags, dia_fill=dia_fill,
        nblocks=nblocks, block_fill=block_fill,
    )


def _decide(f) -> Method:
    """The method-selection gates over a feature getter ``f(name)``.

    Gates are ordered cheapest-feature-first so the staged path in
    :func:`choose_method` can stop computing features at the first hit.
    The thresholds predate the H100 and are not yet calibrated on it
    (ROADMAP.md); the per-method times in PERF.md are their input.
    """
    if f("nnz") == 0 or f("m") == 0:
        return Method.SERIAL
    # Banded/diagonal structure → the zero-gather streaming plan.  Fill
    # gate: streamed zeros must not exceed ~3× the nnz, and the unrolled
    # per-diagonal op count must stay compile-friendly.
    ndiags = f("ndiags")
    if ndiags and ndiags <= 256 and f("dia_fill") >= 0.3:
        return Method.DIA
    # Dense 128x128 block structure → batched block products (the only
    # plan whose irregular ops scale as nnz/16384 instead of nnz).
    if f("block_fill") >= 0.15:
        return Method.BCSR
    # Tiny matrices: compile-simple serial plan is fine.
    if f("nnz") < 10_000:
        return Method.SERIAL
    # Even row lengths: SELL's padding stays small and it needs no scan.
    if f("sell_pad_ratio") <= 1.6:
        return Method.SELL_C_SIGMA
    # Heavy skew / mega-rows: exact-nnz scan handles any distribution.
    return Method.BALANCED


def choose_method(a: CsrMatrix, feats: MatrixFeatures = None) -> Method:
    """Pick the plan for this matrix.

    Cost model: every plan's traffic is ≈ gather(nnz_effective) + streams.
    SELL's nnz_effective is nnz·pad_ratio but it has no scan pass; the scan
    plans touch exactly nnz but add a cumsum pass.  So: prefer SELL while
    padding is modest; fall back to the tiled scan when padding explodes
    (extreme row-length skew) — the same regime where the reference
    switches from SELL to balanced2/CSR5.

    Without ``feats`` the features are computed lazily, cheapest first —
    an obviously banded matrix is routed to DIA after one structure probe.
    """
    if feats is not None:
        return _decide(lambda k: getattr(feats, k))

    cache: dict = {"m": a.m, "n": a.n, "nnz": a.nnz}

    def lazy(k):
        if k in cache:
            return cache[k]
        if k in ("ndiags", "dia_fill"):
            from .formats.dia import dia_profile
            cache["ndiags"], cache["dia_fill"] = (
                dia_profile(a) if a.nnz else (0, 0.0))
        elif k in ("nblocks", "block_fill"):
            from .formats.bcsr import bcsr_profile
            cache["nblocks"], cache["block_fill"] = (
                bcsr_profile(a) if a.nnz else (0, 0.0))
        elif k == "sell_pad_ratio":
            cache[k] = (_sell_pad_ratio(a.row_lengths.astype(np.int64))
                        if a.m else 1.0)
        else:
            raise KeyError(k)
        return cache[k]

    return _decide(lazy)


def _tune_cache_path(mtx_token: str) -> str:
    import os
    d = os.environ.get("SPMV_TPU_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache",
                                    "spmv_tpu"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"tune_{mtx_token}.json")


def tune(a: CsrMatrix, methods=None, iters: int = 5, repeats: int = 2,
         x=None, verbose: bool = False, mtx_token: str = None,
         budget_s: float = None):
    """Measurement-based auto-tuner: build each candidate handle, time it
    honestly, return (best_handle, results).

    This completes the reference README's promised-but-empty
    "Matrix inspect and choose best method to run" (README.md:222-223) with
    the strongest possible implementation: run them and keep the winner.
    ``choose_method`` remains the zero-cost heuristic used by Method.AUTO;
    ``tune`` is for inspect-once/execute-many workloads where a few extra
    seconds of tuning amortize (the same trade the reference's per-method
    pre-deal times embody, e.g. 51s SELL pack for 100 iterations).

    ``mtx_token`` caches the tuned winner on disk keyed by the matrix
    token — the spirit of the reference's partition cache
    (HyperGraphInterface.cpp:22-57): the second call skips the sweep and
    builds only the winning handle.

    ``results`` is a dict method-name -> seconds/iteration (inf on failure,
    or the cached winner's recorded time on a cache hit).

    ``budget_s`` bounds the SWEEP's own wall cost (at
    6M nnz a full sweep is ~8 serial handle builds of seconds each with
    no early stop): once the budget is spent, remaining candidates are
    skipped (recorded as ``inf``) and the best-so-far wins.  The cache
    record stores the sweep's own cost as ``sweep_seconds``.
    """
    import json
    import os

    import jax.numpy as jnp
    from .handle import create_handle
    from .bench.timing import time_spmv_chain
    from .types import METHOD_NAMES

    if mtx_token:
        path = _tune_cache_path(mtx_token)
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            # Validate the record against THIS matrix — the reference's
            # partition cache treats a stored-shape mismatch as a miss
            # (HyperGraphInterface.cpp findToken checks m/nnz); a reused
            # token must never silently apply another matrix's winner.
            # A stale winner can also fail to build (e.g. a cached DIA
            # pick after the matrix stops being banded) — fall back to
            # the full sweep rather than raise where the sweep survives.
            match = (rec.get("m") == a.m
                     and rec.get("nnz") == a.nnz
                     and rec.get("dtype") == str(np.dtype(a.dtype)))
            if match:
                try:
                    h = create_handle(a, method=Method(rec["method"]))
                    return h, {METHOD_NAMES[h.method]:
                               rec.get("seconds", float("nan"))}
                except Exception:  # noqa: BLE001 — stale winner → re-sweep
                    pass

    if methods is None:
        # every distinct execution plan
        methods = [Method.DIA, Method.BCSR, Method.SELL_C_SIGMA,
                   Method.CSR5, Method.BALANCED2, Method.BALANCED,
                   Method.SERIAL]
    if x is None:
        x = np.random.default_rng(0).standard_normal(a.n).astype(a.dtype)
    xj = jnp.asarray(x)

    import time as _time
    sweep_t0 = _time.perf_counter()
    best = None
    results = {}
    for method in methods:
        name = METHOD_NAMES[Method(method)]
        if (budget_s is not None and best is not None
                and _time.perf_counter() - sweep_t0 > budget_s):
            results[name] = float("inf")      # skipped: budget spent
            if verbose:
                print(f"tune: {name} skipped (budget {budget_s:.1f}s "
                      "spent)")
            continue
        try:
            h = create_handle(a, method=method)
            dt = time_spmv_chain(h._bound, xj, iters=iters, k=4,
                                 repeats=repeats)["inclusive"]
        except Exception as e:  # noqa: BLE001 — a failing plan just loses
            results[name] = float("inf")
            if verbose:
                print(f"tune: {name} failed: {e}")
            continue
        results[name] = dt
        if verbose:
            print(f"tune: {name}: {dt*1e3:.3f} ms/iter")
        if best is None or dt < best[0]:
            best = (dt, h, Method(method))
    if best is None:
        raise RuntimeError("tune: every candidate method failed")
    if mtx_token:
        with open(_tune_cache_path(mtx_token), "w") as f:
            json.dump({"method": int(best[2]), "seconds": best[0],
                       "m": int(a.m), "nnz": int(a.nnz),
                       "dtype": str(np.dtype(a.dtype)),
                       "sweep_seconds":
                           round(_time.perf_counter() - sweep_t0, 3)}, f)
    return best[1], results
