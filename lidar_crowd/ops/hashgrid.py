"""Voxel hash-grid neighbor search — the device replacement for KD-trees.

The reference leans on ``sklearn.neighbors.KDTree`` for every radius query
(models/crowd_density_model.py:2, models/crowd_flow_model.py:205,
app_simplified.py:271). Trees are pointer-chasing structures that do not map
to a data-parallel device, so this design uses the classic uniform
grid: bucket points into voxels of edge >= radius, sort by voxel id once
(O(n log n) on-device sort), then any radius-r neighborhood is contained in
the 3^d adjacent voxels, each a contiguous run of the sorted order found by
vectorised binary search. All shapes are static; every candidate slot is
masked. Queries are chunked with ``lax.map`` only to bound the transient
(chunk, 3^d, capacity) gather footprint at large n.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lidar_crowd.types import pytree_dataclass

INT_MAX = jnp.iinfo(jnp.int32).max


@pytree_dataclass
class HashGrid:
    """Sorted voxel bucketing of a padded point set."""

    points: jnp.ndarray         # (N, D) original points
    mask: jnp.ndarray           # (N,) validity
    cell_size: jnp.ndarray      # () float
    origin: jnp.ndarray         # (D,) grid origin (min corner)
    dims: jnp.ndarray           # (D,) int32 voxel counts per axis
    order: jnp.ndarray          # (N,) int32: sorted point indices
    sorted_ids: jnp.ndarray     # (N,) int32 voxel id per sorted slot
                                #     (invalid points get INT_MAX)
    sorted_points: jnp.ndarray  # (N, D) points gathered in sorted order


def _cell_coords(points, origin, cell_size, dims):
    c = jnp.floor((points - origin) / cell_size).astype(jnp.int32)
    return jnp.clip(c, 0, dims - 1)


def _linear_id(coords, dims):
    lid = coords[..., 0]
    for a in range(1, coords.shape[-1]):
        lid = lid * dims[a] + coords[..., a]
    return lid


def build_grid(points: jnp.ndarray, mask: jnp.ndarray,
               cell_size: float) -> HashGrid:
    """Bucket padded/masked ``points`` into voxels of edge ``cell_size``.

    Voxel dims derive from the (dynamic) masked bounding box; shapes stay
    static because dims only feed id arithmetic, never array shapes."""
    big = jnp.asarray(jnp.finfo(points.dtype).max, points.dtype)
    pmin = jnp.min(jnp.where(mask[:, None], points, big), axis=0)
    pmax = jnp.max(jnp.where(mask[:, None], points, -big), axis=0)
    cs = jnp.asarray(cell_size, points.dtype)
    dims = jnp.maximum(jnp.floor((pmax - pmin) / cs).astype(jnp.int32) + 1, 1)

    coords = _cell_coords(points, pmin, cs, dims)
    ids = jnp.where(mask, _linear_id(coords, dims), INT_MAX)
    order = jnp.argsort(ids).astype(jnp.int32)
    return HashGrid(points=points, mask=mask, cell_size=cs, origin=pmin,
                    dims=dims, order=order,
                    sorted_ids=ids[order].astype(jnp.int32),
                    sorted_points=points[order])


def _neighbor_offsets(d: int) -> jnp.ndarray:
    offs = np.array(list(itertools.product((-1, 0, 1), repeat=d)),
                    dtype=np.int32)
    return jnp.asarray(offs)


def _bucket_windows(grid: HashGrid, queries: jnp.ndarray):
    """(start, end) sorted-order window per query per adjacent voxel:
    two (Q, 3^d) int32 arrays."""
    d = queries.shape[-1]
    offs = _neighbor_offsets(d)
    qc = _cell_coords(queries, grid.origin, grid.cell_size, grid.dims)
    nc = qc[:, None, :] + offs[None, :, :]
    in_bounds = jnp.all((nc >= 0) & (nc < grid.dims), axis=-1)
    nid = jnp.where(in_bounds,
                    _linear_id(jnp.clip(nc, 0, grid.dims - 1), grid.dims),
                    INT_MAX - 1)
    starts = jnp.searchsorted(grid.sorted_ids, nid, side="left")
    ends = jnp.searchsorted(grid.sorted_ids, nid, side="right")
    ends = jnp.where(in_bounds, ends, starts)
    return starts.astype(jnp.int32), ends.astype(jnp.int32)


def _candidates(grid: HashGrid, cq: jnp.ndarray, cqm: jnp.ndarray,
                radius, bucket_capacity: int):
    """All candidate neighbors of a query chunk: returns
    (cand_idx (C, M, cap) int32, hit (C, M, cap) bool) where hit marks
    candidates within ``radius`` (inclusive) of a valid query."""
    n = grid.points.shape[0]
    starts, ends = _bucket_windows(grid, cq)
    slot = jnp.arange(bucket_capacity, dtype=jnp.int32)
    pos = starts[:, :, None] + slot[None, None, :]
    valid = pos < ends[:, :, None]
    pos_c = jnp.clip(pos, 0, n - 1)
    cand_idx = grid.order[pos_c]
    diff = grid.sorted_points[pos_c] - cq[:, None, None, :]
    dist2 = jnp.sum(diff * diff, axis=-1)
    r2 = jnp.asarray(radius, cq.dtype) ** 2
    hit = valid & (dist2 <= r2) & cqm[:, None, None]
    return cand_idx, hit


def _chunked(fn, queries, qmask, chunk):
    """Run ``fn`` over query chunks with lax.map; single call if small."""
    q, d = queries.shape
    if q <= chunk:
        return fn((queries, qmask))
    pad = (-q) % chunk
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    mp = jnp.pad(qmask, (0, pad))
    steps = (q + pad) // chunk
    out = jax.lax.map(fn, (qp.reshape(steps, chunk, d),
                           mp.reshape(steps, chunk)))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((steps * chunk,) + x.shape[2:])[:q], out)


def ball_count(grid: HashGrid, queries: jnp.ndarray, qmask: jnp.ndarray,
               radius: float, bucket_capacity: int = 32,
               chunk: int = 16384) -> jnp.ndarray:
    """Exact number of points within ``radius`` (inclusive) of each query —
    sklearn ``query_radius`` semantics; a query that is itself a grid point
    counts itself, as DBSCAN core-point counting expects."""
    def fn(args):
        cq, cqm = args
        _, hit = _candidates(grid, cq, cqm, radius, bucket_capacity)
        return jnp.sum(hit.astype(jnp.int32), axis=(1, 2))

    return _chunked(fn, queries, qmask, chunk)


def ball_query(grid: HashGrid, queries: jnp.ndarray, qmask: jnp.ndarray,
               radius: float, k: int, bucket_capacity: int = 32,
               chunk: int = 8192) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Up to ``k`` neighbor indices within ``radius`` per query (PointNet++
    grouping / adjacency building). Returns (indices (Q, k) int32,
    valid (Q, k) bool), deterministic bucket-scan order."""
    def fn(args):
        cq, cqm = args
        cand_idx, hit = _candidates(grid, cq, cqm, radius, bucket_capacity)
        c = hit.shape[0]
        m = hit.shape[1] * hit.shape[2]
        flat_hit = hit.reshape(c, m)
        flat_idx = cand_idx.reshape(c, m)
        rank = jnp.cumsum(flat_hit.astype(jnp.int32), axis=1) - 1
        take = flat_hit & (rank < k)
        dest = jnp.where(take, rank, k)  # k = spill slot
        rows = jnp.arange(c)[:, None]
        out_idx = jnp.zeros((c, k + 1), jnp.int32
                            ).at[rows, dest].set(flat_idx)[:, :k]
        out_val = jnp.zeros((c, k + 1), bool
                            ).at[rows, dest].set(flat_hit)[:, :k]
        return out_idx, out_val

    return _chunked(fn, queries, qmask, chunk)
