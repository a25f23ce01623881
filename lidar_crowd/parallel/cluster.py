"""Spatially-sharded DBSCAN: venue-scale clustering across a device mesh.

The single-device column-grid clustering (ops/columns.py,
ops/clustering.py) is the per-shard kernel; this module scales it across
an ``sp`` mesh axis by x-striping the venue — the point-cloud analogue of
context/sequence parallelism (SURVEY.md §5): each device owns one
x-stripe of the venue plus an eps-wide HALO of copied boundary points
from its neighbors, so every eps-ball (core test) of an owned point is
evaluated exactly. The per-shard algorithm is

    column grid over owned+halo points          (one scatter)
    exact core test for OWNED points            (column_counts)
    core flags for halo copies                  (one ppermute exchange —
                                                 the owner's verdict, since
                                                 a copy's local ball is
                                                 truncated)
    LOCAL connected components                  (ccl_core_labels — min-
                                                 label sweeps + pointer
                                                 jumping, all on-device)
    global label agreement                      (per-component min-gid,
                                                 reconciled across shards)

Label agreement never re-sweeps: each local component is collapsed to one
scalar (its minimum global point id), and rounds of

    boundary-slot gather -> ppermute -> scatter-min into components

run until a global ``psum`` of changes reaches zero. Boundary slots are
matched positionally via HOST-precomputed index maps (both shards sort
the shared halo-zone points by global id), so the on-device exchange is a
static gather/scatter — no O(points^2) id matching anywhere, which is
what lets this run at BASELINE config-5 scale (10M+ points, 8 shards).
A component spanning k stripes converges in <= k rounds, each round
touching only boundary-zone slots.

The final labels for OWNED points equal the single-device result exactly
(same min-gid fixpoint over the same eps-graph: every core-core edge
(p, q) lies entirely inside the buffer of p's owner because |pq| <= eps
<= halo, and copies of the same point are min-joined by the exchange).

Communication rides the mesh axis with ``ppermute`` (neighbor
pattern, no all-to-all), matching the halo-exchange design of
sharded_flow_and_bottlenecks (parallel/spatial.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from lidar_crowd.ops import columns
from lidar_crowd.ops.clustering import (
    ccl_core_labels, table_to_point_order)
from lidar_crowd.ops.columns import (
    build_column_grid)

INT_MAX = jnp.iinfo(jnp.int32).max


def _stripe_geometry(x: np.ndarray, n_shards: int
                     ) -> Tuple[float, float, np.ndarray]:
    """(lo, width, stripe_of) for equal-width x-stripes of the venue."""
    lo, hi = float(x.min()), float(x.max()) + 1e-6
    width = (hi - lo) / n_shards
    stripe_of = np.clip(((x - lo) / width).astype(np.int64), 0,
                        n_shards - 1)
    return lo, width, stripe_of


def partition_stripes(points: np.ndarray, n_shards: int, halo: float,
                      cap: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Host-side prep: split points into ``n_shards`` x-stripes of equal
    width, each padded buffer carrying its OWN points plus halo copies
    within ``halo`` of its stripe edges.

    Returns (buffers (S, CAP, 3), valid (S, CAP), owned (S, CAP),
    global_ids (S, CAP) int32). ``owned`` marks points whose stripe this
    is (each point owned exactly once); halo copies have owned=False.
    Buffer order is global-id-ascending own points, then global-id-
    ascending halo copies (boundary_maps relies on this being
    deterministic).
    """
    n = len(points)
    x = points[:, 0]
    lo, width, stripe_of = _stripe_geometry(x, n_shards)
    if width < halo:
        raise ValueError(
            f"stripe width {width:.3f} < halo {halo:.3f}: neighbor-only "
            "exchange would miss eps-balls spanning two boundaries — use "
            "fewer shards for this venue extent")

    members = []
    for s in range(n_shards):
        s_lo = lo + s * width
        s_hi = s_lo + width
        own = stripe_of == s
        in_halo = (~own) & (x >= s_lo - halo) & (x < s_hi + halo)
        ids = np.concatenate([np.nonzero(own)[0], np.nonzero(in_halo)[0]])
        members.append((ids, own[ids]))

    need = max(len(ids) for ids, _ in members)
    if cap <= 0:
        cap = max(128, 1 << int(np.ceil(np.log2(max(1, need)))))
    if need > cap:
        raise ValueError(f"stripe needs {need} slots > cap {cap}")

    bufs = np.zeros((n_shards, cap, 3), np.float32)
    valid = np.zeros((n_shards, cap), bool)
    owned = np.zeros((n_shards, cap), bool)
    gids = np.full((n_shards, cap), -1, np.int32)
    for s, (ids, own_flags) in enumerate(members):
        k = len(ids)
        bufs[s, :k] = points[ids]
        valid[s, :k] = True
        owned[s, :k] = own_flags
        gids[s, :k] = ids
    return bufs, valid, owned, gids


def boundary_maps(points: np.ndarray, n_shards: int, halo: float,
                  gids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Host-side matched slot maps for the boundary-zone exchange.

    For the boundary between stripes s and s+1 (at x_b), the SHARED set is
    every point with x in [x_b - halo, x_b + halo): by construction of
    ``partition_stripes`` each such point has a slot in BOTH shard s's
    buffer (own or halo copy) and shard s+1's. Sorting the shared set by
    global id gives positionally-aligned slot lists on both sides, so the
    on-device exchange is gather -> ppermute -> scatter with static
    indices.

    Returns (lmap, lval, rmap, rval), each (S, B): for shard s, ``rmap``
    indexes its slots for the boundary with s+1 (invalid on the last
    shard) and ``lmap`` for the boundary with s-1 (invalid on shard 0);
    shard s's rmap and shard s+1's lmap address the same points in the
    same order.
    """
    n_slots = gids.shape[1]
    x = points[:, 0]
    lo, width, _ = _stripe_geometry(x, n_shards)

    # gid -> slot per shard
    slot_of = np.full((n_shards, len(points)), -1, np.int64)
    for s in range(n_shards):
        live = gids[s] >= 0
        slot_of[s, gids[s, live]] = np.nonzero(live)[0]

    shared = []
    for b in range(n_shards - 1):
        x_b = lo + (b + 1) * width
        ids = np.nonzero((x >= x_b - halo) & (x < x_b + halo))[0]
        shared.append(ids)  # np.nonzero is ascending == gid-sorted

    bmax = max([1] + [len(s) for s in shared])
    lmap = np.full((n_shards, bmax), n_slots, np.int32)
    lval = np.zeros((n_shards, bmax), bool)
    rmap = np.full((n_shards, bmax), n_slots, np.int32)
    rval = np.zeros((n_shards, bmax), bool)
    for b, ids in enumerate(shared):
        k = len(ids)
        rs = slot_of[b, ids]
        ls = slot_of[b + 1, ids]
        assert (rs >= 0).all() and (ls >= 0).all(), \
            "shared boundary point missing from a shard buffer"
        rmap[b, :k] = rs
        rval[b, :k] = True
        lmap[b + 1, :k] = ls
        lval[b + 1, :k] = True
    return lmap, lval, rmap, rval


def sharded_dbscan_labels(bufs: jnp.ndarray, valid: jnp.ndarray,
                          owned: jnp.ndarray, gids: jnp.ndarray,
                          lmap: jnp.ndarray, lval: jnp.ndarray,
                          rmap: jnp.ndarray, rval: jnp.ndarray,
                          eps: float, min_samples: int, mesh: Mesh,
                          axis: str = "sp", ncx: int = 128,
                          ncy: int = 128, column_cap: int = 32,
                          max_rounds: int = 32,
                          max_local_iters: int = 64
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Global DBSCAN labels over stripe-partitioned points.

    Inputs are the arrays from ``partition_stripes`` + ``boundary_maps``
    (leading dim = shards, sharded over ``axis``); ``ncx``/``ncy``/
    ``column_cap`` size each shard's column grid. Returns
    (labels (S, CAP) int32, overflow () int32). For OWNED slots, labels
    hold the representative's global point index (min over the component)
    or -1 for noise — identical to single-device DBSCAN over the full
    cloud. Halo slots are -1. Nonzero overflow means a column exceeded
    ``column_cap`` somewhere and the result dropped points (callers
    retry with a doubled cap, as sharded_dbscan does).
    """
    nsh = mesh.shape[axis]
    right_perm = [(i, i + 1) for i in range(nsh - 1)]
    left_perm = [(i, i - 1) for i in range(1, nsh)]
    stripe = max(8, min(64, ncx // 8))

    def shard_fn(pts, val, own, gid, lm, lv, rm, rv):
        pts, val, own, gid = pts[0], val[0], own[0], gid[0]
        lm, lv, rm, rv = lm[0], lv[0], rm[0], rv[0]
        cap = pts.shape[0]
        lm_safe = jnp.clip(lm, 0, cap - 1)
        rm_safe = jnp.clip(rm, 0, cap - 1)

        grid = build_column_grid(pts, val, min_cell=eps, ncx=ncx, ncy=ncy,
                                 cap=column_cap)
        counts = columns.column_counts(grid, eps, stripe=stripe)
        valid_int = grid.table_valid[1:-1, 1:-1]
        ptidx_int = grid.table_ptidx[1:-1, 1:-1]
        safe_idx = jnp.clip(ptidx_int, 0, cap - 1)
        in_grid = ptidx_int >= 0

        # Exact core test for OWNED slots (their eps-ball is complete in
        # this buffer since halo >= eps).
        owned_int = own[safe_idx] & in_grid
        core_own_int = owned_int & valid_int & (counts >= min_samples)
        core_own_pt = table_to_point_order(
            grid, core_own_int.astype(jnp.int32), 0) > 0

        def exchange(vals_pt, fill):
            """Boundary-zone values both ways; returns what arrived,
            aligned with (lmap, rmap). ppermute zero-fills edge shards —
            masked back to ``fill`` via lval/rval."""
            send_r = jnp.where(rv, vals_pt[rm_safe], fill)
            send_l = jnp.where(lv, vals_pt[lm_safe], fill)
            from_left = jax.lax.ppermute(send_r, axis, right_perm)
            from_right = jax.lax.ppermute(send_l, axis, left_perm)
            return (jnp.where(lv, from_left, fill),
                    jnp.where(rv, from_right, fill))

        # Halo copies learn their owner's core verdict. A copy's own
        # count here is truncated (its ball may extend past our halo), so
        # the flag must come from the owner, whose ball is complete.
        core_i32 = (core_own_pt & own).astype(jnp.int32)
        in_l, in_r = exchange(core_i32, 0)
        core_ext = jnp.concatenate(
            [core_own_pt.astype(jnp.int32), jnp.zeros((1,), jnp.int32)])
        core_ext = core_ext.at[jnp.where(lv, lm, cap)].max(in_l)
        core_ext = core_ext.at[jnp.where(rv, rm, cap)].max(in_r)
        core_pt = core_ext[:cap] > 0
        core_int = core_pt[safe_idx] & in_grid & valid_int

        # LOCAL connected components (labels = local slot indices).
        lab_pt, _ = ccl_core_labels(grid, core_int, eps,
                                    max_iters=max_local_iters,
                                    stripe=stripe)

        # Collapse components to dense ids + one global label each
        # (min gid over members). Dummy component ``cap`` absorbs
        # non-core slots.
        slot = jnp.arange(cap, dtype=jnp.int32)
        is_rep = core_pt & (lab_pt == slot)
        dense_minus1 = jnp.cumsum(is_rep.astype(jnp.int32)) - 1
        comp_of_pt = jnp.where(
            core_pt, dense_minus1[jnp.clip(lab_pt, 0, cap - 1)], cap)
        comp_glabel0 = jnp.full((cap + 1,), INT_MAX, jnp.int32).at[
            comp_of_pt].min(jnp.where(core_pt, gid, INT_MAX))

        comp_l = jnp.where(lv, comp_of_pt[lm_safe], cap)
        comp_r = jnp.where(rv, comp_of_pt[rm_safe], cap)

        def round_fn(state):
            cg, _, rnd = state
            gl_pt = cg[comp_of_pt]
            in_l, in_r = exchange(gl_pt, INT_MAX)
            cg2 = cg.at[comp_l].min(in_l)
            cg2 = cg2.at[comp_r].min(in_r)
            changed = jax.lax.psum(
                jnp.sum((cg2 != cg).astype(jnp.int32)), axis)
            return cg2, changed > 0, rnd + jnp.asarray(1, jnp.int32)

        comp_glabel, _, _ = jax.lax.while_loop(
            lambda s: s[1] & (s[2] < max_rounds), round_fn,
            (comp_glabel0, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
        gl_pt = comp_glabel[comp_of_pt]          # INT_MAX for non-core

        # Border points (owned, valid, non-core): min final label among
        # core eps-neighbors — all present locally with agreed labels.
        gl_int = jnp.where(core_int, gl_pt[safe_idx], INT_MAX)
        border_min_int = columns.column_min_label(
            grid, columns.pad_interior(gl_int, INT_MAX),
            columns.pad_interior(core_int, False), eps, INT_MAX,
            stripe=stripe)
        border_min_pt = table_to_point_order(grid, border_min_int,
                                             INT_MAX)

        out = jnp.where(core_pt, gl_pt, INT_MAX)
        border = val & own & ~core_pt & (border_min_pt != INT_MAX)
        out = jnp.where(border, border_min_pt, out)
        out = jnp.where(out == INT_MAX, -1, out)
        out = jnp.where(val & own, out, -1)
        overflow = jax.lax.psum(grid.overflow, axis)
        return out[None], overflow[None]

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(axis),) * 8,
                       out_specs=(P(axis), P(axis)))
    labels, overflow = fn(bufs, valid, owned, gids, lmap, lval, rmap,
                          rval)
    return labels, overflow[0]


def sharded_dbscan(points: np.ndarray, eps: float, min_samples: int,
                   mesh: Mesh, axis: str = "sp", ncx: int = 0,
                   ncy: int = 0, column_cap: int = 0) -> np.ndarray:
    """Convenience wrapper: full cloud in, per-point global labels out
    (representative global ids, -1 noise), bit-equal to single-device
    DBSCAN. Halo width = eps exactly.

    Per-shard column-grid dims default to eps-sized cells over the
    stripe+halo extent (bounded like Pipeline.fit_capacity) and a cap
    measured from actual occupancy; a column-cap overflow triggers an
    exact retry with the cap doubled (same policy as Pipeline.analyze).
    """
    nsh = mesh.shape[axis]
    bufs, valid, owned, gids = partition_stripes(points, nsh, halo=eps)
    lmap, lval, rmap, rval = boundary_maps(points, nsh, halo=eps, gids=gids)

    def bucket32(v, lo=32):
        return max(lo, ((v + 31) // 32) * 32)

    x, y = points[:, 0], points[:, 1]
    lo_x, width, _ = _stripe_geometry(x, nsh)
    if ncx <= 0:
        ncx = bucket32(min(int((width + 2 * eps) / eps) + 2, 1280))
    if ncy <= 0:
        ncy = bucket32(min(int((y.max() - y.min()) / eps) + 2, 1280))
    if column_cap <= 0:
        # measured occupancy: points per eps-cell, padded 2x, min 8
        cells = max(1.0, ncx * ncy * 0.5)  # ~half the grid covers points
        column_cap = max(8, int(2 * bufs.shape[1] / cells) + 4)

    args = [jnp.asarray(a) for a in
            (bufs, valid, owned, gids, lmap, lval, rmap, rval)]
    while True:
        lab, overflow = sharded_dbscan_labels(
            *args, eps, min_samples, mesh, axis=axis, ncx=ncx, ncy=ncy,
            column_cap=column_cap)
        if int(overflow) == 0:
            break
        column_cap *= 2  # exactness over speed: retry, never drop points
    lab = np.asarray(lab)
    out = np.full(len(points), -1, np.int32)
    g = np.asarray(gids)
    o = np.asarray(owned)
    out[g[o]] = lab[o]
    return out
