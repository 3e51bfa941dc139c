"""Feature tour: every major capability in one script.

Run on any backend (CPU works; a GPU runs the same XLA plans):

    python examples/tour.py
"""

import os
import sys

# allow `python examples/<name>.py` without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

import spmv_tpu as st
from spmv_tpu.io import generate


def main():
    # -- structures and the inspector ------------------------------------
    zoo = {
        "banded": generate.banded(2000, 2000, 4, dtype=np.float32),
        "clustered": generate.clustered(2000, 2000, 24, spread=300,
                                        dtype=np.float32),
        "blocky": generate.block_random(4, 4, 2, fill=0.4,
                                        dtype=np.float32),
        "scattered": generate.random_uniform(2000, 2000, 30,
                                             dtype=np.float32),
    }
    for name, a in zoo.items():
        feats = st.featurize(a)
        h = st.create_handle(a)              # Method.AUTO
        x = np.random.default_rng(0).standard_normal(a.n).astype(np.float32)
        y = np.asarray(st.spmv(h, x))
        ref = st.spmv_golden(a.astype(np.float64), x.astype(np.float64))
        err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1)
        print(f"{name:10s} -> {h!r}  relerr={err:.1e}")

    # -- measurement-based tuning ----------------------------------------
    h, timings = st.tune(zoo["banded"], iters=3, repeats=1)
    print("tune picked:", h.method_name,
          {k: f"{v*1e3:.2f}ms" for k, v in timings.items()})

    # -- f64 (the reference's primary dtype) -------------------------------
    a64 = generate.clustered(2000, 2000, 16, spread=250, dtype=np.float64)
    h64 = st.create_handle(a64, method=st.Method.SELL_C_SIGMA)
    x64 = np.random.default_rng(2).standard_normal(2000)
    y64 = np.asarray(st.spmv(h64, x64))
    ref64 = st.spmv_golden(a64, x64)
    print(f"f64 handle: {h64!r}  maxrel="
          f"{np.abs(y64-ref64).max()/np.abs(ref64).max():.1e}")

    # -- locality reordering ----------------------------------------------
    scramble = np.random.default_rng(1).permutation(2000)
    scrambled, _ = st.formats.reorder.reorder_symmetric(
        zoo["clustered"], scramble)
    h2 = st.create_handle(scrambled, method=st.Method.BALANCED,
                          reorder="cluster")   # label-propagation (METIS role)
    x = np.ones(2000, np.float32)
    print("reordered handle:", repr(h2), "perm set:", h2.perm is not None)

    # -- handle lifecycle: clear + re-prep (reference parity) --------------
    h2.clear()
    h2.prepare(st.Method.BALANCED_YID)
    print("re-prepped:", h2.method_name)

    # -- multi-device (virtual mesh on CPU, real mesh on several GPUs) -----
    import jax
    if len(jax.devices()) > 1 or jax.default_backend() == "cpu":
        from spmv_tpu.parallel import (build_dist_plan, dist_spmv,
                                       make_mesh_1d)
        mesh = make_mesh_1d(min(len(jax.devices()), 8))
        plan = build_dist_plan(zoo["banded"].astype(np.float64), mesh,
                               x_mode="halo")
        y = np.asarray(dist_spmv(plan, np.ones(2000)))
        print(f"dist halo spmv on {plan.ndev} device(s): y[:3] = {y[:3]}")

    # -- the roofline model ------------------------------------------------
    a = zoo["banded"]
    print("roofline @3350 GB/s (csr model, H100 HBM peak):",
          f"{st.utils.roofline_gflops(a.m, a.n, a.nnz, 3350.0):.1f} GFLOP/s")


if __name__ == "__main__":
    main()
