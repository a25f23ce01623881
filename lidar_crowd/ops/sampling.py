"""Point sampling ops.

- ``farthest_point_sampling``: the PointNet++ downsampler, in the
  distance-cache formulation (one (N,) min-distance vector updated per
  selected point — the sequential outer loop runs as ``lax.fori_loop`` on
  device while each step is a full-width argmax, SURVEY.md §7 hard
  part (e)).
- ``random_downsample``: reference semantics
  (utils/data_processing.py:231-249) with a JAX PRNG key.
- ``voxel_downsample``: one representative point per voxel — the
  structured alternative the reference lacks.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def farthest_point_sampling(points: jnp.ndarray, mask: jnp.ndarray,
                            n_samples: int,
                            start_index: int = 0) -> jnp.ndarray:
    """Select ``n_samples`` indices spreading over the valid points.

    points: (N, D) padded; mask: (N,). Returns (n_samples,) int32 indices.
    Invalid points are never selected (distance -inf); if fewer valid
    points than samples exist, indices repeat (callers mask by unique).
    """
    n = points.shape[0]
    big = jnp.asarray(jnp.finfo(points.dtype).max, points.dtype)

    def body(i, state):
        dists, selected, last = state
        lastp = points[last]
        d = jnp.sum((points - lastp[None, :]) ** 2, axis=1)
        dists = jnp.minimum(dists, d)
        masked = jnp.where(mask, dists, -big)
        nxt = jnp.argmax(masked).astype(jnp.int32)
        selected = selected.at[i].set(nxt)
        return dists, selected, nxt

    init_d = jnp.full((n,), big, points.dtype)
    selected0 = jnp.zeros((n_samples,), jnp.int32).at[0].set(start_index)
    # first distance update happens against start_index; loop fills 1..M-1
    _, selected, _ = jax.lax.fori_loop(
        1, n_samples, body,
        (init_d, selected0, jnp.asarray(start_index, jnp.int32)))
    return selected


def random_downsample(key: jax.Array, points: jnp.ndarray,
                      mask: jnp.ndarray,
                      factor: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep ~``factor`` of the valid points (masked out, not removed —
    static shapes). Reference: np.random.choice without replacement
    (data_processing.py:231-249)."""
    if factor >= 1.0:
        return points, mask
    u = jax.random.uniform(key, (points.shape[0],))
    keep = mask & (u < factor)
    # guarantee at least one point survives
    any_keep = jnp.any(keep)
    first_valid = jnp.argmax(mask)
    keep = keep.at[first_valid].set(keep[first_valid] | ~any_keep & mask[first_valid])
    return points, keep


def voxel_downsample(points: jnp.ndarray, mask: jnp.ndarray,
                     voxel_size: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep one representative (lowest padded index) per voxel.

    A 3-key stable sort groups voxel-mates without ever flattening the
    voxel coordinates into one integer — the flattened id overflows
    int32 for venue-scale extents at centimetre voxels (and int64 is
    unavailable without jax_enable_x64). Stability makes the first row
    of each group the lowest original index."""
    big = jnp.asarray(jnp.finfo(points.dtype).max, points.dtype)
    pmin = jnp.min(jnp.where(mask[:, None], points, big), axis=0)
    coords = jnp.floor((points - pmin) / voxel_size).astype(jnp.int32)
    imax = jnp.iinfo(jnp.int32).max
    cx = jnp.where(mask, coords[:, 0], imax)
    cy = jnp.where(mask, coords[:, 1], imax)
    cz = jnp.where(mask, coords[:, 2], imax)
    n = points.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    scx, scy, scz, sidx = jax.lax.sort((cx, cy, cz, idx), num_keys=3)
    is_first = jnp.concatenate([
        jnp.ones((1,), bool),
        (scx[1:] != scx[:-1]) | (scy[1:] != scy[:-1])
        | (scz[1:] != scz[:-1])])
    keep_sorted = is_first & (scx != imax)
    keep = jnp.zeros(n, bool).at[sidx].set(keep_sorted)
    return points, keep
