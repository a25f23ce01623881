"""Device-side preprocessing pipeline.

Device re-design of utils/data_processing.py:127-229 (modular) and
app_simplified.py:76-137 (monolith): height-ramp colors, 3-sigma outlier
rejection, percentile ground split, closed-form least-squares ground plane,
and DBSCAN-equivalent person clustering — all under one ``jit`` with static
shapes. Rejected outliers are *masked*, not removed (XLA static shapes), so
every downstream reduction is mask-aware.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lidar_crowd.config import PipelineConfig
from lidar_crowd.ops import clustering
from lidar_crowd.types import PointCloud, ProcessedCloud


def _masked_mean(x: jnp.ndarray, mask: jnp.ndarray, axis=0) -> jnp.ndarray:
    m = mask.astype(x.dtype)
    if x.ndim > mask.ndim:
        m = m[..., None]
    cnt = jnp.maximum(jnp.sum(m, axis=axis), 1.0)
    return jnp.sum(x * m, axis=axis) / cnt


def _masked_std(x: jnp.ndarray, mask: jnp.ndarray, axis=0) -> jnp.ndarray:
    mu = _masked_mean(x, mask, axis)
    var = _masked_mean((x - mu) ** 2, mask, axis)
    return jnp.sqrt(var)


def masked_percentile(x: jnp.ndarray, mask: jnp.ndarray,
                      q: float) -> jnp.ndarray:
    """np.percentile(x[mask], q) with linear interpolation, on padded data.

    Invalid entries sort to +inf at the tail; the percentile index is
    computed against the dynamic valid count (data_processing.py:164)."""
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    xs = jnp.sort(jnp.where(mask, x, big))
    n = jnp.sum(mask.astype(jnp.int32))
    pos = (n - 1).astype(x.dtype) * (q / 100.0)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.ceil(pos).astype(jnp.int32)
    frac = pos - lo.astype(x.dtype)
    lo_v = xs[jnp.clip(lo, 0, x.shape[0] - 1)]
    hi_v = xs[jnp.clip(hi, 0, x.shape[0] - 1)]
    return lo_v + (hi_v - lo_v) * frac


def fit_ground_plane(points: jnp.ndarray, ground_mask: jnp.ndarray,
                     all_mask: jnp.ndarray) -> jnp.ndarray:
    """Least-squares z = ax + by + c over ground points, returned as
    [a, b, -1, c] (data_processing.py:169-183). Solved closed-form via the
    3x3 normal equations — lstsq for a 3-parameter model as two matrix
    products and a 3x3 solve. The products run at full f32 precision
    (a GPU would otherwise take them in TF32, ~3 decimal digits). Falls
    back to a horizontal plane when there are too few ground points."""
    m = ground_mask.astype(points.dtype)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    one = jnp.ones_like(x)
    cols = jnp.stack([x, y, one], axis=1) * m[:, None]
    hi = jax.lax.Precision.HIGHEST
    ata = jnp.matmul(cols.T, cols, precision=hi)        # (3, 3)
    atb = jnp.matmul(cols.T, z * m, precision=hi)       # (3,)
    # Regularise the (rare) rank-deficient case; lstsq would return the
    # minimum-norm solution, the fallback below covers degenerate inputs.
    sol = jnp.linalg.solve(ata + 1e-6 * jnp.eye(3, dtype=points.dtype), atb)
    plane = jnp.array([1.0, 1.0, -1.0, 1.0], points.dtype) * jnp.array(
        [sol[0], sol[1], 1.0, sol[2]], points.dtype)

    n_ground = jnp.sum(ground_mask.astype(jnp.int32))
    big = jnp.asarray(jnp.finfo(points.dtype).max, points.dtype)
    zmin = jnp.min(jnp.where(all_mask, z, big))
    fallback = jnp.array([0.0, 0.0, 1.0, 0.0], points.dtype).at[3].set(-zmin)
    return jnp.where(n_ground > 10, plane, fallback)


def preprocess(cloud: PointCloud, config: PipelineConfig) -> ProcessedCloud:
    """Full preprocessing under jit. ``config`` is static."""
    pc = config.preprocess
    cap = config.capacity
    pts = cloud.points
    mask = cloud.mask

    # Height-ramp colors over the *raw* cloud (data_processing.py:143-147).
    z = pts[:, 2]
    big = jnp.asarray(jnp.finfo(pts.dtype).max, pts.dtype)
    zmin = jnp.min(jnp.where(mask, z, big))
    zmax = jnp.max(jnp.where(mask, z, -big))
    nh = (z - zmin) / (zmax - zmin + 1e-10)
    colors = jnp.stack([nh, 0.5 * (1.0 - nh), jnp.full_like(nh, 0.5)],
                       axis=1)

    # 3-sigma outlier mask (data_processing.py:151-156). np.std is the
    # population std, matching _masked_std.
    mean = _masked_mean(pts, mask)
    std = _masked_std(pts, mask)
    inlier = mask & jnp.all(jnp.abs(pts - mean) < pc.outlier_sigma * std,
                            axis=1)

    normals = jnp.zeros_like(pts).at[:, 2].set(1.0)

    # Ground split at the z percentile (data_processing.py:164-166).
    z_thresh = masked_percentile(z, inlier, pc.ground_percentile)
    ground = inlier & (z <= z_thresh)
    non_ground = inlier & ~ground

    plane = fit_ground_plane(pts, ground, inlier)

    # Person clustering on non-ground points.
    n_ng = jnp.sum(non_ground.astype(jnp.int32))
    if pc.variant == "modular":
        # StandardScaler + adaptive eps (data_processing.py:188-198):
        # eps = clip(0.5 * mean(per-axis std of standardized pts), .2, .5).
        # After standardisation each axis std is 1, but sklearn standardises
        # with the *non-ground subset* stats — replicate with masked stats.
        mu = _masked_mean(pts, non_ground)
        sd = jnp.maximum(_masked_std(pts, non_ground), 1e-12)
        scaled = (pts - mu) / sd
        # std of scaled masked points is 1 per axis by construction, so the
        # adaptive eps is the constant clip(0.5*1, 0.2, 0.5) == 0.5
        eps = min(max(0.5 * 1.0, 0.2), 0.5)
        cluster_pts = scaled
    else:
        eps = pc.dbscan_eps
        cluster_pts = pts

    # Compact the non-ground points to the front of a (usually smaller)
    # cluster buffer: the all-pairs DBSCAN path is quadratic in its static
    # capacity, and ~30% of points are ground + padding. A stable argsort
    # on ~non_ground keeps point order within the compacted prefix, so
    # min-point-index cluster representatives are preserved.
    ccap = min(cap.cluster_capacity or cloud.points.shape[0],
               cloud.points.shape[0])
    if pc.variant == "modular":
        # eps = 0.5 sigma is macroscopic in standardized space, so the
        # eps-column grid degenerates (see dbscan_labels); the packed
        # brute force is the only exact backend and bounds the capacity.
        # Points past the clamp surface in the overflow diagnostic; the
        # pipeline raises rather than return a silently-wrong census.
        ccap = min(ccap, clustering.BRUTEFORCE_HARD_CAP)
    if ccap < cloud.points.shape[0]:
        order = jnp.argsort(~non_ground, stable=True).astype(jnp.int32)
        inv_order = jnp.zeros_like(order).at[order].set(
            jnp.arange(order.shape[0], dtype=jnp.int32))
        compact_pts = cluster_pts[order[:ccap]]
        compact_mask = non_ground[order[:ccap]]
        n_ng_total = jnp.sum(non_ground.astype(jnp.int32))
        compact_overflow = jnp.maximum(n_ng_total - ccap, 0)
    else:
        # full-capacity buffer: the column/CCL path masks ground points
        # itself, so the compaction reorder (an n-element argsort plus
        # two gathers) is pure overhead
        inv_order = None
        compact_pts = cluster_pts
        compact_mask = non_ground
        compact_overflow = jnp.asarray(0, jnp.int32)

    labels_c, n_clusters, overflow = clustering.dbscan_labels(
        compact_pts, compact_mask, eps, pc.dbscan_min_samples,
        ncx=cap.cluster_cells_x, ncy=cap.cluster_cells_y,
        column_cap=cap.cluster_column_cap, max_iters=cap.max_cc_iters,
        brute_cap=(clustering.BRUTEFORCE_HARD_CAP
                   if pc.variant == "modular"
                   else clustering.BRUTEFORCE_MAX_POINTS))
    overflow = overflow + compact_overflow

    # back to full point order
    if inv_order is None:
        labels = labels_c
    else:
        labels_full = jnp.pad(labels_c, (0, cloud.points.shape[0] - ccap),
                              constant_values=-1)
        labels = labels_full[inv_order]

    # Reference skips clustering when <= min_cluster_points non-ground
    # points and labels them all cluster 0 (data_processing.py:188-200).
    few = n_ng <= pc.min_cluster_points
    labels = jnp.where(few & non_ground, 0, labels)
    labels = jnp.where(ground | ~inlier, -1, labels)
    n_clusters = jnp.where(few, jnp.where(n_ng > 0, 1, 0), n_clusters)

    mins = jnp.min(jnp.where(inlier[:, None], pts, big), axis=0)
    maxs = jnp.max(jnp.where(inlier[:, None], pts, -big), axis=0)

    return ProcessedCloud(
        points=pts, mask=inlier, colors=colors, normals=normals,
        labels=labels.astype(jnp.int32), ground_mask=ground,
        ground_plane=plane, mins=mins, maxs=maxs,
        n_clusters=n_clusters.astype(jnp.int32),
        cluster_overflow=overflow.astype(jnp.int32))
