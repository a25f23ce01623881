"""Crowd-density analytics on device.

Device re-design of models/crowd_density_model.py and the monolith variant
app_simplified.py:234-316. Two density modes:

  - "radius": the monolith's per-cell KD-tree radius-2 count
    (app_simplified.py:269-281) — the hottest loop in the reference —
    becomes a brute-force masked cell-centre x people distance reduction.
    Chunked with lax.map over (C_chunk, K) tiles to bound memory; above
    BUCKETED_MIN_PAIRS pair tests a coarse-bucketed count takes over.
  - "histogram": np.histogram2d semantics (utils/data_processing.py:282-328)
    as a masked scatter-add.

Hotspot extraction is a fixed-capacity top-k over the flattened grid with
the reference's iteration order preserved for tie-breaking (monolith scans
y-major: app_simplified.py:288-295; modular scans x-major:
crowd_density_model.py:56-59).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lidar_crowd.config import PipelineConfig
from lidar_crowd.types import (
    DensityResults, People, ProcessedCloud)
from lidar_crowd.ops import clustering


def extract_people(processed: ProcessedCloud,
                   config: PipelineConfig) -> People:
    """Cluster centroids -> xy positions (data_processing.py:251-280)."""
    cents, valid, overflow = clustering.cluster_centroids(
        processed.points, processed.labels, config.capacity.max_people)
    return People(positions=cents[:, :2], mask=valid, z=cents[:, 2],
                  overflow=overflow)


def _arange_len(start, stop, step):
    """Length of np.arange(start, stop, step) (ceil semantics)."""
    return jnp.maximum(jnp.ceil((stop - start) / step), 0.0).astype(jnp.int32)


# Engage the coarse-bucketed radius count above this many cell x people
# pair tests: brute force is dense elementwise work with zero gathers,
# while at venue scale (921k cells x 450k people ~ 4e11 pairs) the
# 9 * bucket_cap * cells formulation is ~1000x less work.
BUCKETED_MIN_PAIRS = 1 << 32


def radius_count_grid(people: People, origin, nx, ny, gx_cap: int,
                      gy_cap: int, grid_size: float, radius: float,
                      chunk: int = 512, bucket_cap: int = 0
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """people-within-radius count per cell centre, x-major grid (GX, GY).

    Returns (counts, overflow): overflow is the number of people DROPPED
    because a coarse bucket exceeded ``bucket_cap`` (0 on the brute
    paths, which are always exact) — the pipeline doubles the cap and
    re-runs, the same exactness contract as the clustering column cap.

    Cell (i, j) centre = origin + (i+0.5, j+0.5)*grid_size. Brute-force over
    the padded people set — a dense (chunk, K) masked reduction per cell
    chunk. Above BUCKETED_MIN_PAIRS pair tests (and with ``bucket_cap`` >
    0) people are bucketed once into a radius-sized coarse grid and every
    cell reads its 3x3 neighborhood (ops/bucket_density.py) —
    bit-identical counts, ~1000x less work at venue scale. The choice
    depends on static capacities only.
    """
    k = people.positions.shape[0]
    g = jnp.asarray(grid_size, people.positions.dtype)
    r2 = jnp.asarray(radius, people.positions.dtype) ** 2
    zero = jnp.asarray(0, jnp.int32)

    if bucket_cap > 0 and gx_cap * gy_cap * k >= BUCKETED_MIN_PAIRS:
        from lidar_crowd.ops import (
            bucket_density)
        counts, overflow = bucket_density.radius_count_bucketed(
            people.positions, people.mask, origin, gx_cap, gy_cap,
            grid_size, radius, bucket_cap)
        ci = jnp.arange(gx_cap, dtype=jnp.int32)[:, None]
        cj = jnp.arange(gy_cap, dtype=jnp.int32)[None, :]
        cell_valid = (ci < nx) & (cj < ny)
        return jnp.where(cell_valid, counts, 0), overflow

    total = gx_cap * gy_cap
    flat = jnp.arange(total, dtype=jnp.int32)
    ci = flat // gy_cap
    cj = flat % gy_cap
    centers = jnp.stack(
        [origin[0] + (ci.astype(g.dtype) + 0.5) * g,
         origin[1] + (cj.astype(g.dtype) + 0.5) * g], axis=1)
    cell_valid = (ci < nx) & (cj < ny)

    ppl = people.positions
    pmask = people.mask

    def chunk_fn(args):
        c, cv = args
        d2 = jnp.sum((c[:, None, :] - ppl[None, :, :]) ** 2, axis=-1)
        cnt = jnp.sum((d2 <= r2) & pmask[None, :], axis=1)
        return jnp.where(cv, cnt, 0)

    steps = total // chunk if total % chunk == 0 else -(-total // chunk)
    pad = steps * chunk - total
    centers_p = jnp.pad(centers, ((0, pad), (0, 0)))
    cv_p = jnp.pad(cell_valid, (0, pad))
    counts = jax.lax.map(
        chunk_fn, (centers_p.reshape(steps, chunk, 2),
                   cv_p.reshape(steps, chunk)))
    return counts.reshape(-1)[:total].reshape(gx_cap, gy_cap), zero


def histogram_grid(people: People, origin, nx, ny, gx_cap: int, gy_cap: int,
                   grid_size: float) -> jnp.ndarray:
    """Masked scatter-add histogram of people positions, x-major (GX, GY).

    np.histogram2d puts values equal to the last edge into the final bin;
    people always lie within [min, max] + margin here, so a clip to the
    valid bin range reproduces that semantics."""
    g = jnp.asarray(grid_size, people.positions.dtype)
    rel = (people.positions - origin[None, :]) / g
    bi = jnp.clip(jnp.floor(rel[:, 0]).astype(jnp.int32), 0, nx - 1)
    bj = jnp.clip(jnp.floor(rel[:, 1]).astype(jnp.int32), 0, ny - 1)
    flat = bi * gy_cap + bj
    flat = jnp.where(people.mask, flat, gx_cap * gy_cap)  # overflow slot
    hist = jnp.zeros(gx_cap * gy_cap + 1, people.positions.dtype
                     ).at[flat].add(1.0)[:-1]
    return hist.reshape(gx_cap, gy_cap)


def top_hotspots(grid: jnp.ndarray, cell_valid: jnp.ndarray,
                 centers_x: jnp.ndarray, centers_y: jnp.ndarray,
                 threshold, max_hotspots: int, y_major: bool):
    """Fixed-capacity top-k hotspot cells >= threshold.

    ``y_major`` selects the flat scan order used by the reference variant so
    ties resolve identically (Python ``sorted`` is stable)."""
    if y_major:
        flat = grid.T.reshape(-1)
        fv = cell_valid.T.reshape(-1)
        fx = jnp.broadcast_to(centers_x[None, :], grid.T.shape).reshape(-1)
        fy = jnp.broadcast_to(centers_y[:, None], grid.T.shape).reshape(-1)
    else:
        flat = grid.reshape(-1)
        fv = cell_valid.reshape(-1)
        fx = jnp.broadcast_to(centers_x[:, None], grid.shape).reshape(-1)
        fy = jnp.broadcast_to(centers_y[None, :], grid.shape).reshape(-1)

    eligible = fv & (flat >= threshold)
    neg_inf = jnp.asarray(-jnp.inf, flat.dtype)
    scores = jnp.where(eligible, flat, neg_inf)
    top_v, top_i = jax.lax.top_k(scores, max_hotspots)
    hmask = top_v > neg_inf
    hx = fx[top_i]
    hy = fy[top_i]
    return (jnp.stack([hx, hy], axis=1), jnp.where(hmask, top_v, 0.0), hmask)


def analyze_density(processed: ProcessedCloud, people: People,
                    config: PipelineConfig) -> DensityResults:
    cap = config.capacity
    dc = config.density
    g = jnp.asarray(dc.grid_size, processed.points.dtype)
    x0, x1 = processed.mins[0], processed.maxs[0]
    y0, y1 = processed.mins[1], processed.maxs[1]
    total_people = people.count

    if dc.mode == "radius":
        # Monolith path (app_simplified.py:234-316).
        # avg = people / max(1, bbox area); python max(1, area) semantics.
        area = (x1 - x0) * (y1 - y0)
        avg_density = total_people.astype(g.dtype) / jnp.maximum(1.0, area)
        # grid edges arange(x0, x1+g, g) -> nx = len-1
        nx = jnp.clip(_arange_len(x0, x1 + g, g) - 1, 1, cap.grid_cells_x)
        ny = jnp.clip(_arange_len(y0, y1 + g, g) - 1, 1, cap.grid_cells_y)
        origin = jnp.stack([x0, y0])
        grid, radius_overflow = radius_count_grid(
            people, origin, nx, ny, cap.grid_cells_x, cap.grid_cells_y,
            dc.grid_size, dc.radius, bucket_cap=cap.density_bucket_cap)
        grid = grid.astype(g.dtype) / dc.radius_area
        y_major = True
    else:
        # Modular histogram path with 2-cell margin
        # (utils/data_processing.py:282-328).
        margin = dc.margin_cells * g
        ox, oy = x0 - margin, y0 - margin
        nx = jnp.clip(_arange_len(ox, x1 + margin + g, g) - 1,
                      1, cap.grid_cells_x)
        ny = jnp.clip(_arange_len(oy, y1 + margin + g, g) - 1,
                      1, cap.grid_cells_y)
        origin = jnp.stack([ox, oy])
        grid = histogram_grid(people, origin, nx, ny, cap.grid_cells_x,
                              cap.grid_cells_y, dc.grid_size) / (g * g)
        radius_overflow = jnp.asarray(0, jnp.int32)
        y_major = False

    ci = jnp.arange(cap.grid_cells_x)
    cj = jnp.arange(cap.grid_cells_y)
    cell_valid = (ci[:, None] < nx) & (cj[None, :] < ny)
    grid = jnp.where(cell_valid, grid, 0.0)

    max_density = jnp.max(grid)
    if dc.mode == "histogram":
        # avg over nonzero cells (crowd_density_model.py:64)
        pos = cell_valid & (grid > 0)
        s = jnp.sum(jnp.where(pos, grid, 0.0))
        c = jnp.sum(pos.astype(g.dtype))
        avg_density = jnp.where(c > 0, s / jnp.maximum(c, 1.0), 0.0)

    threshold = jnp.maximum(dc.hotspot_min_threshold,
                            avg_density * dc.hotspot_avg_multiplier)
    centers_x = origin[0] + (ci.astype(g.dtype) + 0.5) * g
    centers_y = origin[1] + (cj.astype(g.dtype) + 0.5) * g
    hxy, hdens, hmask = top_hotspots(grid, cell_valid, centers_x, centers_y,
                                     threshold, dc.max_hotspots, y_major)

    # Empty-people semantics (crowd_density_model.py:37-46 /
    # app_simplified.py:310-313): zero stats, no hotspots.
    empty = total_people == 0
    zero = jnp.asarray(0.0, g.dtype)
    return DensityResults(
        total_people=total_people,
        avg_density=jnp.where(empty & (dc.mode == "histogram"), zero,
                              avg_density),
        max_density=jnp.where(empty, zero, max_density),
        density_grid=jnp.where(empty, jnp.zeros_like(grid), grid),
        origin=origin, nx=nx, ny=ny,
        hotspot_xy=hxy, hotspot_density=jnp.where(hmask & ~empty, hdens, 0.0),
        hotspot_mask=hmask & ~empty, radius_overflow=radius_overflow)
