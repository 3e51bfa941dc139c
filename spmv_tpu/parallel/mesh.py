"""Multi-chip SpMV over a device mesh.

Re-design of the reference's NUMA-partitioned sample
(``src/samples/numa.c:268-439``), which splits matrix rows into per-NUMA-node
blocks (and optionally the x vector too) and runs pinned threads.  Here the
"nodes" are accelerator devices on a 1-D mesh axis:

* **Row sharding**: rows are split into one contiguous block per device,
  balanced by *nnz* rather than row count — the same quantile splitter the
  reference uses per thread (``init_csrSplitter_balanced``,
  parallel_balanced_spmv.c:39-58), reused across chips exactly as SURVEY.md
  §7 step 6 prescribes.
* **Static shapes**: every device's CSR streams are padded to the mesh-wide
  maximum and stacked into ``(ndev, ...)`` arrays so one jitted ``shard_map``
  program serves all shards.
* **x placement**: ``x_mode="replicated"`` keeps x whole on every chip (the
  reference numa sample's fallback; right when n is small).
  ``x_mode="allgather"`` shards x across the mesh and all-gathers it over the device interconnect
  inside the shard — the analog of the reference's cross-node reads
  (numa.c:151-153), but as an explicit XLA collective the compiler can
  overlap with compute.
* **No scatter**: each shard computes its row block with the tiled-scan plan
  (ops/xla_csr.py); the blocks concatenate along the mesh axis and a single
  static gather restores the (padded) row order.

Works identically on a GPU mesh (NCCL collectives over NVLink) and on the
8-device virtual CPU mesh
used by tests and the driver's dry-run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from ..types import CsrMatrix, INT_DTYPE
from ..formats.partition import balanced_row_splitter
from ..ops import xla_csr

__all__ = ["DistSpmvPlan", "build_dist_plan", "dist_spmv",
           "DistDiaPlan", "build_dist_dia_plan", "dist_dia_spmv",
           "DistAutoPlan", "build_dist_auto", "dist_auto_spmv",
           "make_mesh_1d"]


def make_mesh_1d(n_devices: Optional[int] = None, axis: str = "rows") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


@dataclasses.dataclass
class DistSpmvPlan:
    """Row-sharded SpMV plan: static metadata + device-sharded arrays."""

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    tile: int
    mr: int                      # padded rows per shard
    row_splitter: np.ndarray     # (ndev+1,) global row boundaries
    x_mode: str                  # "replicated" | "allgather"
    # sharded device arrays, leading dim = ndev:
    colidx_pad: jax.Array        # (ndev, L) local col indices (globally valid)
    vals_pad: jax.Array          # (ndev, L)
    row_start: jax.Array         # (ndev, mr) positions into local padded stream
    row_end: jax.Array           # (ndev, mr)
    out_index: jax.Array         # (m,) gather map from (ndev*mr,) to row order
    identity_out: bool = False   # out_index is arange(m) → skip the gather
    # halo mode: separate LOCAL stream (no dependency on the ppermute ring,
    # overlappable with the exchange); the main stream holds the REMOTE nnz
    loc_colidx: Any = None       # (ndev, L2)
    loc_vals: Any = None
    loc_row_start: Any = None
    loc_row_end: Any = None
    loc_tile: int = 0
    _exec: object = None         # cached jitted executable

    def __call__(self, x) -> jax.Array:
        return dist_spmv(self, x)


def _pad_to(arr: np.ndarray, length: int, fill=0) -> np.ndarray:
    out = np.full(length, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _put_sharded(arr, sharding):
    """``device_put`` that also works on meshes spanning multiple processes.

    Multi-host placement (jax.distributed) cannot device_put onto
    non-addressable devices; build the global array from the host copy via
    per-shard callbacks instead (every process holds the same host array —
    the builders are deterministic).
    """
    local = jax.process_count() == 1 or all(
        d.process_index == jax.process_index()
        for d in sharding.device_set)
    if local:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def build_dist_plan(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                    tile: int = 2048, x_mode: str = "replicated",
                    halo_shards: int = 1) -> DistSpmvPlan:
    """Partition rows over the mesh (nnz-balanced) and place shards.

    The per-device block construction mirrors the reference numa sample's
    per-node sub-matrix build (numa.c:277-304) but with static padded shapes
    so XLA compiles one program for all shards.

    ``x_mode="halo"``: x is sharded in equal blocks and each shard fetches
    only its neighbor blocks via ppermute rings — communication is
    O(halo·n/ndev) per chip instead of O(n) (the device analog of the
    reference numa sample's neighbor reads, numa.c:151-153).  The ring
    depth is computed from the matrix (``halo_shards`` is a floor); rows
    stay nnz-balanced.  Raises ValueError when columns reach so far that
    the ring would cover the whole mesh (reorder for locality first —
    formats/reorder.py ``cluster_order`` — or use "allgather").
    """
    if x_mode not in ("replicated", "allgather", "halo"):
        raise ValueError(f"unknown x_mode {x_mode!r}")
    ndev = mesh.shape[axis]
    if x_mode == "halo":
        return _build_dist_plan_halo(a, mesh, axis, tile, halo_shards)
    splitter = balanced_row_splitter(a.rowptr, ndev).astype(np.int64)
    rowptr64 = a.rowptr.astype(np.int64)

    mr = max(int(np.max(splitter[1:] - splitter[:-1])), 1)
    shard_nnz = rowptr64[splitter[1:]] - rowptr64[splitter[:-1]]
    # local stream length: +1 for the prepended zero (see TileScanPlan), then
    # rounded to the tile size; same L for every shard.
    L = max(-(-(int(shard_nnz.max()) + 1) // tile) * tile, tile)

    colidx = np.zeros((ndev, L), dtype=INT_DTYPE)
    vals = np.zeros((ndev, L), dtype=a.vals.dtype)
    row_start = np.zeros((ndev, mr), dtype=INT_DTYPE)
    row_end = np.zeros((ndev, mr), dtype=INT_DTYPE)
    for d in range(ndev):
        r0, r1 = int(splitter[d]), int(splitter[d + 1])
        p0, p1 = int(rowptr64[r0]), int(rowptr64[r1])
        nr = r1 - r0
        colidx[d, 1: 1 + p1 - p0] = a.colidx[p0:p1]
        vals[d, 1: 1 + p1 - p0] = a.vals[p0:p1]
        # With the prepended zero, the original stream element p sits at
        # padded index p - p0 + 1, so the exclusive prefix sum at boundary p
        # equals the INCLUSIVE scan at index p - p0; padded rows point at
        # index 0 (start == end) → y = 0.
        row_start[d, :nr] = (rowptr64[r0:r1] - p0).astype(INT_DTYPE)
        row_end[d, :nr] = (rowptr64[r0 + 1: r1 + 1] - p0).astype(INT_DTYPE)

    # y comes out as (ndev*mr,) = concat of padded shard blocks; row i of the
    # global matrix lives at shard d(i), local slot i - splitter[d].
    owner = np.searchsorted(splitter, np.arange(a.m), side="right") - 1
    out_index = (owner * mr + (np.arange(a.m) - splitter[owner])).astype(INT_DTYPE)
    # When the nnz-balanced split happens to be uniform, the gather is the
    # identity — skip it (one m-length gather per exec saved).
    identity_out = bool(np.array_equal(out_index, np.arange(a.m)))

    sh = functools.partial(NamedSharding, mesh)
    dev_sharded = lambda arr: jax.device_put(arr, sh(P(axis)))
    plan = DistSpmvPlan(
        mesh=mesh, axis=axis, ndev=ndev, m=a.m, n=a.n, nnz=a.nnz,
        tile=tile, mr=mr, row_splitter=splitter, x_mode=x_mode,
        colidx_pad=dev_sharded(colidx),
        vals_pad=dev_sharded(vals),
        row_start=dev_sharded(row_start),
        row_end=dev_sharded(row_end),
        out_index=jax.device_put(out_index, sh(P())),
        identity_out=identity_out,
    )
    plan._exec = _build_executable(plan)
    return plan


def _build_dist_plan_halo(a: CsrMatrix, mesh: Mesh, axis: str,
                          tile: int, h_min: int,
                          balance: str = "nnz") -> DistSpmvPlan:
    """Halo-exchange plan on an nnz-balanced (or uniform) row split.

    x is sharded in UNIFORM blocks of bx = ceil(n/ndev); rows split by nnz
    quantiles (``balance="nnz"``, the reference splitter semantics) or
    uniformly.  The ring depth h is computed from the data: the maximum
    x-block distance any shard's columns reach (a locality reorder —
    formats/reorder.py cluster_order — shrinks it).
    """
    ndev = mesh.shape[axis]
    if a.m != a.n:
        raise ValueError("halo mode requires a square matrix")
    rowptr64 = a.rowptr.astype(np.int64)
    if balance == "nnz":
        splitter = balanced_row_splitter(a.rowptr, ndev).astype(np.int64)
    else:
        splitter = np.minimum(np.arange(ndev + 1, dtype=np.int64)
                              * max(-(-a.m // ndev), 1), a.m)
    mr = max(int(np.max(splitter[1:] - splitter[:-1])), 1)

    # x blocks FOLLOW the row splitter (block d = x[splitter[d]:splitter[d+1]]
    # padded to mr) so nnz balance never inflates the ring depth; the input
    # rearrangement gather is skipped when the split happens to be uniform.
    owner_of = np.searchsorted(splitter, np.arange(a.m), side="right") - 1
    out_index = (owner_of * mr + (np.arange(a.m) - splitter[owner_of])) \
        .astype(INT_DTYPE)
    identity_out = bool(np.array_equal(out_index, np.arange(a.m)))

    # required ring depth: max row-block distance of any shard's columns,
    # measured MODULO ndev (the ppermute rings are circular, so a
    # cyclic-banded matrix — row 0 referencing column n-1 — is depth 1 via
    # wrap-around, not ndev-1)
    h = h_min
    for d in range(ndev):
        p0, p1 = int(rowptr64[splitter[d]]), int(rowptr64[splitter[d + 1]])
        if p1 > p0:
            own = owner_of[a.colidx[p0:p1]]
            fw = (own - d) % ndev
            h = max(h, int(np.minimum(fw, (ndev - fw) % ndev).max()))
    if 2 * h + 1 > ndev:
        raise ValueError(
            f"halo depth {h} needs {2 * h + 1} blocks > ndev={ndev}; "
            "columns reach too far — reorder for locality (cluster/rcm) "
            "or use x_mode='allgather'")

    # Two nnz streams per shard — LOCAL (column owned by the shard itself)
    # and REMOTE (column in a neighbor block).  The local scan has no data
    # dependency on the ppermute ring, so XLA can overlap the halo exchange
    # with the bulk of the compute (SURVEY §7 step 6's "free win"; the
    # locality reorder makes the local stream the large one).
    loc_counts = np.zeros((ndev, mr), dtype=np.int64)
    rem_counts = np.zeros((ndev, mr), dtype=np.int64)
    loc_streams, rem_streams = [], []
    for d in range(ndev):
        r0, r1 = int(splitter[d]), int(splitter[d + 1])
        p0, p1 = int(rowptr64[r0]), int(rowptr64[r1])
        cols_d = a.colidx[p0:p1].astype(np.int64)
        vals_d = a.vals[p0:p1]
        own = owner_of[cols_d] if cols_d.size else cols_d
        is_loc = own == d
        # per-row counts (rows are sorted in the CSR stream)
        rows_d = np.repeat(np.arange(r1 - r0),
                           np.diff(rowptr64[r0:r1 + 1]).astype(np.int64))
        np.add.at(loc_counts[d], rows_d[is_loc], 1)
        np.add.at(rem_counts[d], rows_d[~is_loc], 1)
        # window position of block ``own`` in x_ext = [d-h .. d+h] blocks,
        # ring-circular: equals own - (d - h) when no wrap occurs
        local = ((own - d + h) % ndev) * mr + (cols_d - splitter[own])
        loc_streams.append(((cols_d - splitter[d])[is_loc],
                            vals_d[is_loc]))
        rem_streams.append((local[~is_loc], vals_d[~is_loc]))

    def _stack(streams, counts):
        ln = max(max((len(c) for c, _ in streams), default=0) + 1, 1)
        L = max(-(-ln // tile) * tile, tile)
        colidx = np.zeros((ndev, L), dtype=INT_DTYPE)
        vals = np.zeros((ndev, L), dtype=a.vals.dtype)
        row_start = np.zeros((ndev, mr), dtype=INT_DTYPE)
        row_end = np.zeros((ndev, mr), dtype=INT_DTYPE)
        for d, (c, v) in enumerate(streams):
            colidx[d, 1: 1 + len(c)] = c.astype(INT_DTYPE)
            vals[d, 1: 1 + len(v)] = v
            ends = np.cumsum(counts[d])
            row_start[d] = (ends - counts[d]).astype(INT_DTYPE)
            row_end[d] = ends.astype(INT_DTYPE)
        return colidx, vals, row_start, row_end

    colidx, vals, row_start, row_end = _stack(rem_streams, rem_counts)
    lcol, lval, lstart, lend = _stack(loc_streams, loc_counts)

    sh = functools.partial(NamedSharding, mesh)
    dev_sharded = lambda arr: _put_sharded(arr, sh(P(axis)))
    plan = DistSpmvPlan(
        mesh=mesh, axis=axis, ndev=ndev, m=a.m, n=a.n, nnz=a.nnz,
        tile=tile, mr=mr, row_splitter=splitter, x_mode="halo",
        colidx_pad=dev_sharded(colidx),
        vals_pad=dev_sharded(vals),
        row_start=dev_sharded(row_start),
        row_end=dev_sharded(row_end),
        out_index=_put_sharded(out_index, sh(P())),
        identity_out=identity_out,
        loc_colidx=dev_sharded(lcol),
        loc_vals=dev_sharded(lval),
        loc_row_start=dev_sharded(lstart),
        loc_row_end=dev_sharded(lend),
        loc_tile=tile,
    )
    plan._halo = h
    plan._bx = mr
    if not identity_out:
        # input-side rearrangement: x into splitter-aligned blocks (pads
        # read x_pad[m] == 0).  One n-scale gather per exec on non-uniform
        # splits — skipped entirely for uniform ones.
        base = splitter[:-1, None] + np.arange(mr)[None, :]
        lens = (splitter[1:] - splitter[:-1])[:, None]
        in_index = np.where(np.arange(mr)[None, :] < lens, base,
                            a.m).reshape(-1)
        plan._in_index = jax.device_put(in_index.astype(INT_DTYPE),
                                        NamedSharding(mesh, P()))
    else:
        plan._in_index = None
    plan._exec = _build_executable(plan)
    return plan


def _build_executable(plan: DistSpmvPlan):
    mesh, axis = plan.mesh, plan.axis
    x_sharded = plan.x_mode == "allgather"
    halo = getattr(plan, "_halo", 0) if plan.x_mode == "halo" else 0
    ndev = plan.ndev

    identity_out = plan.identity_out
    m = plan.m

    if halo:
        def shard_body(colidx, vals, row_start, row_end,
                       lcol, lval, lstart, lend, x):
            # assemble [own-h .. own+h] blocks via ppermute rings; circular
            # wrap values are dead weight (columns never escape the window,
            # enforced at build), localized indices point into this window.
            # The LOCAL stream depends only on the own block, so XLA is free
            # to overlap the ring exchange with it (the two scans join only
            # at the final add — SURVEY §7 step 6's comm/compute overlap).
            xb = x[0]
            parts = [xb]
            fwd = xb
            bwd = xb
            for _ in range(halo):
                fwd = jax.lax.ppermute(
                    fwd, axis, [(i, (i + 1) % ndev) for i in range(ndev)])
                bwd = jax.lax.ppermute(
                    bwd, axis, [(i, (i - 1) % ndev) for i in range(ndev)])
                parts = [fwd] + parts + [bwd]
            x_ext = jnp.concatenate(parts)
            y_loc = xla_csr.scan_spmv_tiled(lcol[0], lval[0], lstart[0],
                                            lend[0], xb,
                                            tile=plan.loc_tile)
            y_rem = xla_csr.scan_spmv_tiled(colidx[0], vals[0],
                                            row_start[0], row_end[0],
                                            x_ext, tile=plan.tile)
            return (y_loc + y_rem)[None, :]

        smap = jax.shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(axis),) * 8 + (P(axis),),
            out_specs=P(axis),
        )

        @jax.jit
        def run_halo(colidx, vals, row_start, row_end,
                     lcol, lval, lstart, lend, x, out_index):
            x = x.reshape(ndev, -1)
            y_blocks = smap(colidx, vals, row_start, row_end,
                            lcol, lval, lstart, lend, x)
            if identity_out:
                return y_blocks.reshape(-1)[:m]
            return xla_csr.gather_x(y_blocks.reshape(-1), out_index)

        return run_halo

    def shard_body(colidx, vals, row_start, row_end, x):
        # blocks arrive as (1, L) / (1, mr) — one shard of the leading dim
        if x_sharded:
            x = jax.lax.all_gather(x, axis, tiled=True)
        y = xla_csr.scan_spmv_tiled(colidx[0], vals[0], row_start[0],
                                    row_end[0], x, tile=plan.tile)
        return y[None, :]

    smap = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  P(axis) if x_sharded else P()),
        out_specs=P(axis),
    )

    @jax.jit
    def run(colidx, vals, row_start, row_end, x, out_index):
        y_blocks = smap(colidx, vals, row_start, row_end, x)  # (ndev*mr,)
        if identity_out:
            # uniform splits lay blocks out in row order already — the gather
            # would be pure waste
            return y_blocks.reshape(-1)[:m]
        return xla_csr.gather_x(y_blocks.reshape(-1), out_index)

    return run


def _pad_x(x: jax.Array, n: int, n_pad: int) -> jax.Array:
    """Zero-pad x from n to n_pad (even sharding for sharded x modes)."""
    if n_pad == n:
        return x
    return jnp.concatenate([x, jnp.zeros(n_pad - n, x.dtype)])


def dist_spmv(plan: DistSpmvPlan, x) -> jax.Array:
    """Execute y = A @ x across the mesh."""
    x = jnp.asarray(x)
    if x.shape != (plan.n,):
        raise ValueError(f"x has shape {x.shape}, expected ({plan.n},)")
    if plan.x_mode == "allgather":
        x = _pad_x(x, plan.n, -(-plan.n // plan.ndev) * plan.ndev)
        x = jax.device_put(x, NamedSharding(plan.mesh, P(plan.axis)))
    elif plan.x_mode == "halo":
        if plan._in_index is None:          # uniform split: pure zero-pad
            x = _pad_x(x, plan.n, plan._bx * plan.ndev)
        else:                               # splitter-aligned block gather
            x_pad = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
            x = xla_csr.gather_x(x_pad, plan._in_index)
        x = jax.device_put(x, NamedSharding(plan.mesh, P(plan.axis)))
    else:
        x = jax.device_put(x, NamedSharding(plan.mesh, P()))
    if plan.x_mode == "halo":
        return plan._exec(plan.colidx_pad, plan.vals_pad, plan.row_start,
                          plan.row_end, plan.loc_colidx, plan.loc_vals,
                          plan.loc_row_start, plan.loc_row_end, x,
                          plan.out_index)
    return plan._exec(plan.colidx_pad, plan.vals_pad, plan.row_start,
                      plan.row_end, x, plan.out_index)


# ---------------------------------------------------------------------------
# Distributed DIA (banded) plan — zero-gather SpMV across the mesh.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistDiaPlan:
    """Row-blocked DIA over a 1-D mesh: shard d owns rows
    [d*mr, (d+1)*mr); each shard runs the shifted-stream FMA plan
    (ops/xla_csr.dia_spmv) against the replicated (or all-gathered) x.

    The banded analog of the reference's NUMA row-blocking (numa.c:277-304):
    where the general plan balances nnz, DIA rows carry uniform work so the
    split is uniform in rows.

    ``x_mode="halo"`` is the true halo exchange SURVEY.md §7 step 6 calls
    for: x is sharded like the rows and each shard ppermutes only the band
    edges (max |offset| elements) to its neighbors — communication shrinks
    from O(n) per chip (allgather) to O(bandwidth), riding neighbor
    links.  Wrap-around edge values are harmless: the diagonal data stores
    structural zeros outside the band.  Requires m == n and
    max |offset| ≤ n/ndev.
    """

    mesh: Mesh
    axis: str
    ndev: int
    m: int
    n: int
    nnz: int
    offsets: tuple
    mr: int                     # rows per shard (padded)
    data: jax.Array             # (ndev, ndiags, mr) sharded
    x_mode: str
    _exec: object = None

    def __call__(self, x) -> jax.Array:
        return dist_dia_spmv(self, x)


def build_dist_dia_plan(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                        x_mode: str = "replicated") -> DistDiaPlan:
    from ..formats.dia import pack_dia
    if x_mode not in ("replicated", "allgather", "halo"):
        raise ValueError(f"unknown x_mode {x_mode!r}")
    d = pack_dia(a)
    ndev = mesh.shape[axis]
    mr = max(-(-a.m // ndev), 1)
    if x_mode == "halo":
        if a.m != a.n:
            raise ValueError("halo mode requires a square matrix")
        h = max((max(abs(int(o)) for o in d.offsets), 1)) \
            if len(d.offsets) else 1
        if h > mr:
            raise ValueError(
                f"halo {h} exceeds shard width {mr}; use allgather")
    data = np.zeros((ndev, len(d.offsets), mr), dtype=d.data.dtype)
    for dev in range(ndev):
        r0 = dev * mr
        r1 = min(r0 + mr, a.m)
        if r1 > r0:
            data[dev, :, : r1 - r0] = d.data[:, r0:r1]
    plan = DistDiaPlan(
        mesh=mesh, axis=axis, ndev=ndev, m=a.m, n=a.n, nnz=a.nnz,
        offsets=tuple(int(o) for o in d.offsets), mr=mr,
        data=jax.device_put(data, NamedSharding(mesh, P(axis))),
        x_mode=x_mode,
    )
    plan._exec = _build_dia_executable(plan)
    return plan


def _build_dia_executable(plan: DistDiaPlan):
    from ..ops import xla_csr
    mesh, axis = plan.mesh, plan.axis
    x_sharded = plan.x_mode == "allgather"
    mr, n, offsets = plan.mr, plan.n, plan.offsets
    ndev = plan.ndev

    if plan.x_mode == "halo":
        h = max(max(abs(int(o)) for o in offsets), 1) if offsets else 1
        fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
        bwd = [(i, (i - 1) % ndev) for i in range(ndev)]

        def shard_body(data, x):
            if not offsets:
                return jnp.zeros((1, mr), x.dtype)
            xb = x[0]                                   # (mx,) local block
            # band edges ride neighbor links only (O(h) words per shard)
            from_left = jax.lax.ppermute(xb[-h:], axis, fwd)
            from_right = jax.lax.ppermute(xb[:h], axis, bwd)
            x_ext = jnp.concatenate([from_left, xb, from_right])
            acc = jnp.zeros(mr, x.dtype)
            for k, o in enumerate(offsets):
                seg = jax.lax.dynamic_slice_in_dim(x_ext, h + o, mr)
                acc = acc + data[0, k] * seg
            return acc[None, :]

        smap = jax.shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
        )

        @jax.jit
        def run(data, x):
            return smap(data, x.reshape(ndev, -1)).reshape(-1)

        return run

    def shard_body(data, x):
        if x_sharded:
            x = jax.lax.all_gather(x, axis, tiled=True)
        if not offsets:                  # empty matrix: y = 0
            return jnp.zeros((1, mr), x.dtype)
        # shard d computes rows [d*mr, (d+1)*mr): global row i = d*mr + il,
        # so its x offsets shift by +d*mr relative to the local row index.
        dev = jax.lax.axis_index(axis)
        row0 = dev * mr
        # pad x so every (offset + row0) slice is in range
        omin, omax = min(offsets), max(offsets)
        pad_l = max(0, -omin)
        pad_r = max(0, mr * plan.ndev + omax - n) + mr
        xpad = jnp.concatenate([
            jnp.zeros(pad_l, x.dtype), x, jnp.zeros(pad_r, x.dtype)])
        acc = jnp.zeros(mr, x.dtype)
        for k, o in enumerate(offsets):
            seg = jax.lax.dynamic_slice_in_dim(xpad, pad_l + o + row0, mr)
            acc = acc + data[0, k] * seg
        return acc[None, :]

    smap = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(axis), P(axis) if x_sharded else P()),
        out_specs=P(axis),
    )

    @jax.jit
    def run(data, x):
        return smap(data, x).reshape(-1)

    return run


def dist_dia_spmv(plan: DistDiaPlan, x) -> jax.Array:
    x = jnp.asarray(x)
    if x.shape != (plan.n,):
        raise ValueError(f"x has shape {x.shape}, expected ({plan.n},)")
    if plan.x_mode in ("allgather", "halo"):
        n_pad = (plan.mr * plan.ndev if plan.x_mode == "halo"
                 else -(-plan.n // plan.ndev) * plan.ndev)
        x = _pad_x(x, plan.n, n_pad)
        x = jax.device_put(x, NamedSharding(plan.mesh, P(plan.axis)))
    else:
        x = jax.device_put(x, NamedSharding(plan.mesh, P()))
    y = plan._exec(plan.data, x)
    return y[: plan.m]


# ---------------------------------------------------------------------------
# Distributed AUTO — one-call mesh handle
#
# The single-device inspector fulfills the reference's promised-but-empty
# auto-tuner (README.md:222-223) on one device; this extends it across the
# mesh: pick the dist plan family (DIA or the exact-nnz scan) with the same
# DIA gate as inspector._decide, and pick x placement (replicated /
# allgather / halo) from the measured column spread — the reference's NUMA
# sample (numa.c:268-439) makes the user hand-pick both.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistAutoPlan:
    """A mesh SpMV plan chosen automatically; call it like a function."""

    kind: str                # "dia" | "scan"
    x_mode: str
    m: int
    n: int
    nnz: int
    plan: Any                # the DistDiaPlan or DistSpmvPlan it runs
    #: halo-mode straggler stream: (rows, cols, vals) of the ≤0.1%
    #: long-range nonzeros split out so the quantile halo gate holds
    rest: Optional[tuple] = None

    def __call__(self, x) -> jax.Array:
        return dist_auto_spmv(self, x)


def _auto_x_mode(a: CsrMatrix, ndev: int) -> str:
    """Pick x placement from the data.

    halo: square matrix whose columns stay within ±1 x-block of their row
    block (banded / locality-reordered — the ppermute ring moves only
    O(mr) per shard and overlaps the local stream).  The gate uses the
    99.9th percentile of column spread, NOT the max — one long-range
    nonzero must not flip an otherwise banded matrix to allgather; the
    ≤0.1% stragglers ride the plan-level rest stream
    (:func:`_halo_straggler_split`), like the single-chip plans split
    stragglers routinely (reference NUMA analog: numa.c:151-153 hands
    every method an arbitrary row range).  replicated: small x (broadcast
    cost ≈ one shard's stream).  allgather: everything else — x sharded,
    gathered over the interconnect inside the shard.
    """
    if a.m == a.n and a.nnz and ndev > 2:
        mr = -(-a.m // ndev)
        rows = np.repeat(np.arange(a.m, dtype=np.int64),
                         a.row_lengths)
        spread = np.abs(a.colidx.astype(np.int64) - rows)
        if np.quantile(spread, 0.999) <= mr:
            return "halo"
    return "replicated" if a.n <= 1_000_000 else "allgather"


def _halo_straggler_split(a: CsrMatrix, mr: int):
    """Split nonzeros with column spread > ``mr`` into a COO rest stream.

    Returns ``(main, rest)`` — ``main`` keeps halo depth 1 viable, the
    rest (``None`` when nothing spills) executes outside the shard_map
    against the full x like every other plan-level straggler stream."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_lengths)
    cols = np.asarray(a.colidx, dtype=np.int64)
    far = np.abs(cols - rows) > mr
    if not far.any():
        return a, None
    keep = ~far
    rp = np.zeros(a.m + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=a.m), out=rp[1:])
    main = CsrMatrix(a.m, a.n, rp, np.asarray(a.colidx)[keep],
                     np.asarray(a.vals)[keep])
    rest = (rows[far], cols[far], np.asarray(a.vals)[far])
    return main, rest


def build_dist_auto(a: CsrMatrix, mesh: Mesh, axis: str = "rows",
                    x_mode: str = "auto") -> DistAutoPlan:
    """One-call distributed handle: pick the plan family AND x placement.

    Banded matrices (the inspector's DIA gate) → dist DIA; everything else →
    the exact-nnz scan, which serves any matrix and dtype.  x placement
    degrades halo → allgather → replicated when a plan refuses it.
    """
    ndev = mesh.shape[axis]
    xm = _auto_x_mode(a, ndev) if x_mode == "auto" else x_mode
    auto_rest = None
    if xm == "halo" and a.m == a.n and a.nnz:
        # long-range stragglers out of the sharded stream so halo depth 1
        # holds; they execute once against the full x per call
        a, far = _halo_straggler_split(a, -(-a.m // ndev))
        if far is not None:
            auto_rest = (jnp.asarray(far[0].astype(INT_DTYPE)),
                         jnp.asarray(far[1].astype(INT_DTYPE)),
                         jnp.asarray(far[2]))

    def _with_fallback(build, *args, **kw):
        # halo needs structure; allgather/replicated always assemble —
        # degrade x placement rather than fail the family
        modes = [xm] + [m for m in ("allgather", "replicated")
                        if m != xm]
        err = None
        for m in modes:
            try:
                return build(*args, x_mode=m, **kw), m
            except ValueError as e:
                err = e
        raise err

    if a.nnz:
        from ..formats.dia import dia_profile
        ndiags, fill = dia_profile(a)
        if ndiags and ndiags <= 256 and fill >= 0.3:
            plan, m_used = _with_fallback(build_dist_dia_plan, a, mesh, axis)
            return DistAutoPlan(kind="dia", x_mode=m_used, m=a.m, n=a.n,
                                nnz=a.nnz, plan=plan, rest=auto_rest)
    plan, m_used = _with_fallback(build_dist_plan, a, mesh, axis)
    return DistAutoPlan(kind="scan", x_mode=m_used, m=a.m, n=a.n,
                        nnz=a.nnz, plan=plan, rest=auto_rest)


def dist_auto_spmv(plan: DistAutoPlan, x) -> jax.Array:
    """Execute a :func:`build_dist_auto` plan."""
    y = plan.plan(x)
    if plan.rest is not None:
        rows, cols, vals = plan.rest
        xr = jnp.asarray(x)
        y = y.at[rows].add((vals * xr[cols]).astype(y.dtype))
    return y
