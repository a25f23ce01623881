"""Dense 2.5D column-grid neighbor structure — the device layout for
crowd-scale point clouds.

Venue LiDAR scans are intrinsically 2.5D: metres to hundreds of metres in
xy, ~2 m in z. Instead of a pointer-chasing KD-tree (reference:
sklearn KDTree) or an irregular bucketed gather, points are packed ONCE
into a dense (NCX, NCY, CAP) table of xy-columns with edge >= the query
radius. Every radius-eps relation then lives in the 3x3 adjacent columns,
and "visit the neighbor column" is a *static slice* of the dense table —
no gather, no scatter, fully fusible elementwise work. The z dimension
rides along inside each column and is resolved by the exact pairwise
distance test.

Memory discipline: tables are stored padded by one border cell on each
side, and every neighborhood reduction runs over x-stripes via ``lax.map``
— per-stripe intermediates are (stripe, NCY, CAP, CAP) and fuse into
(stripe, NCY, CAP) outputs, so device memory use is bounded regardless of venue
size (a naive 9-way shifted-copy formulation OOMs at ~200K points).

One N-element scatter builds the table; one N-element gather reads results
back in point order. Everything in between is dense.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from lidar_crowd.types import pytree_dataclass


@pytree_dataclass
class ColumnGrid:
    """Dense xy-column bucketing of a padded point set.

    Table axes: (NCX+2, NCY+2, CAP, ...) — border cells are empty padding
    so 3x3 neighborhoods are interior static slices. ``point_pos`` maps
    each original point to its flat padded-table position (last slot =
    spill for overflow/invalid points)."""

    table_xyz: jnp.ndarray    # (NCX+2, NCY+2, CAP, D)
    table_valid: jnp.ndarray  # (NCX+2, NCY+2, CAP) bool
    table_ptidx: jnp.ndarray  # (NCX+2, NCY+2, CAP) int32, -1 invalid
    point_pos: jnp.ndarray    # (N,) int32 flat padded position (or spill)
    cell: jnp.ndarray         # () cell edge (>= query radius)
    origin: jnp.ndarray       # (2,) xy of interior cell (0,0) corner
    overflow: jnp.ndarray     # () int32 points dropped by CAP overflow


def build_column_grid(points: jnp.ndarray, mask: jnp.ndarray,
                      min_cell: float, ncx: int, ncy: int,
                      cap: int) -> ColumnGrid:
    """Pack padded ``points`` into xy-columns.

    Cell edge = max(min_cell, extent/ncells) so the static (ncx, ncy) grid
    always covers the venue while keeping the 3x3-coverage invariant
    (cell >= query radius)."""
    n, d = points.shape
    dt = points.dtype
    big = jnp.asarray(jnp.finfo(dt).max, dt)
    pmin = jnp.min(jnp.where(mask[:, None], points[:, :2], big), axis=0)
    pmax = jnp.max(jnp.where(mask[:, None], points[:, :2], -big), axis=0)
    cell = jnp.maximum(
        jnp.asarray(min_cell, dt),
        jnp.maximum((pmax[0] - pmin[0]) / (ncx - 1e-3),
                    (pmax[1] - pmin[1]) / (ncy - 1e-3)))

    cx = jnp.clip(jnp.floor((points[:, 0] - pmin[0]) / cell).astype(
        jnp.int32), 0, ncx - 1)
    cy = jnp.clip(jnp.floor((points[:, 1] - pmin[1]) / cell).astype(
        jnp.int32), 0, ncy - 1)
    # padded-table cell id (border offset +1)
    px, py = ncx + 2, ncy + 2
    cid = jnp.where(mask, (cx + 1) * py + (cy + 1), px * py)

    # slot = rank within column, via one sort over cell ids. Rank within
    # each equal-cid run = i - (cummax of run-start indices): one scan,
    # cheaper than the log(n) binary-search gathers of searchsorted.
    order = jnp.argsort(cid).astype(jnp.int32)
    sorted_cid = cid[order]
    i32 = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([
        jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]])
    first = jax.lax.cummax(jnp.where(is_start, i32, 0))
    slot_sorted = i32 - first
    slots = jnp.zeros(n, jnp.int32).at[order].set(slot_sorted)

    spill = px * py * cap
    flat = jnp.where(mask & (slots < cap), cid * cap + slots, spill)
    overflow = jnp.sum((mask & (slots >= cap)).astype(jnp.int32))

    tbl_xyz = jnp.zeros((spill + 1, d), dt).at[flat].set(points)
    tbl_valid = jnp.zeros((spill + 1,), bool).at[flat].set(mask)
    tbl_idx = jnp.full((spill + 1,), -1, jnp.int32).at[flat].set(
        jnp.arange(n, dtype=jnp.int32))

    return ColumnGrid(
        table_xyz=tbl_xyz[:spill].reshape(px, py, cap, d),
        table_valid=tbl_valid[:spill].reshape(px, py, cap),
        table_ptidx=tbl_idx[:spill].reshape(px, py, cap),
        point_pos=flat, cell=cell, origin=pmin, overflow=overflow)


OFFSETS_3X3 = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


def stripe_neighborhood_reduce(tables: Tuple[jnp.ndarray, ...],
                               reduce_fn: Callable, stripe: int = 8,
                               fills: Tuple = (),
                               center_tables: Tuple[jnp.ndarray, ...] = (),
                               center_fills: Tuple = ()):
    """Run a 3x3-neighborhood reduction over x-stripes of padded tables.

    ``tables`` are padded (NCX+2, NCY+2, ...) arrays. For each stripe of
    interior rows, ``reduce_fn(center_tables, shifted_tables_for_offset,
    (dx, dy)) -> partial`` is evaluated per offset on (stripe, NCY, ...)
    slices and combined by the caller inside reduce_fn's returned
    accumulator; reduce_fn receives an accumulator-style signature:
        reduce_fn(acc, centers, neighbors, offset) -> acc
    and the initial ``acc`` comes from ``reduce_fn(None, centers, None,
    None)``.

    Returns the stacked interior result with leading dims (NCX, NCY).

    ``fills`` supplies the padding value per table for the x-overhang when
    NCX is not a multiple of ``stripe`` (dynamic_slice would otherwise
    clamp the final stripe onto misaligned rows).
    """
    px = tables[0].shape[0]
    ncx = px - 2
    ncy = tables[0].shape[1] - 2
    nstripes = -(-ncx // stripe)
    overhang = nstripes * stripe - ncx

    def overpad(ts, fs):
        return tuple(
            jnp.pad(t, [(0, overhang)] + [(0, 0)] * (t.ndim - 1),
                    constant_values=f)
            for t, f in zip(ts, fs))

    if overhang:
        tables = overpad(tables, fills)
        center_tables = overpad(center_tables, center_fills)

    def body(i):
        x0 = i * stripe + 1
        # stripe rows [x0, x0+stripe), plus the x-halo handled per offset;
        # center-only tables (e.g. the packed adjacency) are sliced once
        # and never per-offset.
        centers = tuple(
            jax.lax.dynamic_slice_in_dim(t, x0, stripe, axis=0)[:, 1:-1]
            for t in tables) + tuple(
            jax.lax.dynamic_slice_in_dim(t, x0, stripe, axis=0)[:, 1:-1]
            for t in center_tables)
        acc = reduce_fn(None, centers, None, None)
        for dx, dy in OFFSETS_3X3:
            nbrs = tuple(
                jax.lax.dynamic_slice_in_dim(t, x0 + dx, stripe, axis=0)
                [:, 1 + dy:1 + dy + ncy]
                for t in tables)
            acc = reduce_fn(acc, centers, nbrs, (dx, dy))
        return acc

    out = jax.lax.map(body, jnp.arange(nstripes, dtype=jnp.int32))
    # out leading dims: (nstripes, stripe, NCY, ...)
    out = jax.tree_util.tree_map(
        lambda x: x.reshape((nstripes * stripe,) + x.shape[2:])[:ncx], out)
    return out


def column_counts(grid: ColumnGrid, radius, stripe: int = 8) -> jnp.ndarray:
    """Per-slot count of valid points within ``radius`` (inclusive; counts
    self — sklearn neighborhood semantics). Returns interior
    (NCX, NCY, CAP) int32."""
    r2 = jnp.asarray(radius, grid.table_xyz.dtype) ** 2

    def fn(acc, centers, nbrs, off):
        cxyz, cval = centers
        if acc is None:
            return jnp.zeros(cval.shape, jnp.int32)
        kxyz, kval = nbrs
        d2 = jnp.sum(
            (cxyz[:, :, :, None, :] - kxyz[:, :, None, :, :]) ** 2,
            axis=-1)
        hit = (d2 <= r2) & kval[:, :, None, :]
        return acc + jnp.sum(hit, axis=-1)

    counts = stripe_neighborhood_reduce(
        (grid.table_xyz, grid.table_valid), fn, stripe,
        fills=(0.0, False))
    return jnp.where(grid.table_valid[1:-1, 1:-1], counts, 0)


def column_min_label(grid: ColumnGrid, labels_tbl: jnp.ndarray,
                     allowed_tbl: jnp.ndarray, radius, int_max: int,
                     stripe: int = 8) -> jnp.ndarray:
    """Per-slot min over labels of allowed eps-neighbors in the 3x3
    adjacent columns. ``labels_tbl``/``allowed_tbl`` are padded tables;
    returns interior (NCX, NCY, CAP) int32 (int_max where none)."""
    r2 = jnp.asarray(radius, grid.table_xyz.dtype) ** 2

    def fn(acc, centers, nbrs, off):
        cxyz, _, _ = centers
        if acc is None:
            return jnp.full(cxyz.shape[:-1], int_max, jnp.int32)
        kxyz, klab, kallow = nbrs
        d2 = jnp.sum(
            (cxyz[:, :, :, None, :] - kxyz[:, :, None, :, :]) ** 2,
            axis=-1)
        hit = (d2 <= r2) & kallow[:, :, None, :]
        cand = jnp.where(hit, klab[:, :, None, :], int_max)
        return jnp.minimum(acc, jnp.min(cand, axis=-1))

    return stripe_neighborhood_reduce(
        (grid.table_xyz, labels_tbl, allowed_tbl), fn, stripe,
        fills=(0.0, int_max, False))


def pad_interior(interior: jnp.ndarray, fill) -> jnp.ndarray:
    """Inverse of interior slicing: wrap an (NCX, NCY, ...) array back into
    the padded (NCX+2, NCY+2, ...) layout."""
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (interior.ndim - 2)
    return jnp.pad(interior, pad, constant_values=fill)
