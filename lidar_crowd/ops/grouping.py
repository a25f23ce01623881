"""Ball-query grouping and pooling for set-abstraction layers.

``ball_group``: for M query centroids over N source points, return up to K
neighbor indices within radius r — the PointNet++ grouping primitive. Two
backends, dispatched on the static source size:

  - dense: a tiled (M_chunk, N) masked distance pass + top_k (zero
    gathers until the final feature pick-up); first-K-in-scan-order
    selection matches the classic CUDA ball-query semantics. Exact, but
    its O(M*N) work grows with the source, so it is capped at
    BRUTEFORCE_MAX_SOURCE points.
  - hashgrid (ops/hashgrid.py): voxel bucketing + 3^3-neighborhood
    window scan, for sources past that cap. Selection is first-K in
    voxel-scan order (a
    different, still deterministic, K-subset when a neighborhood exceeds
    K — PointNet++ semantics permit any K-subset) and each neighbor
    voxel contributes at most ``bucket_capacity`` candidates (64 covers
    person-cluster densities; raise it for pathological point piles).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

# Above this source count the dense path's O(M*N) distance work gives
# way to voxel bucketing.
BRUTEFORCE_MAX_SOURCE = 262_144


def ball_group(queries: jnp.ndarray, qmask: jnp.ndarray,
               points: jnp.ndarray, pmask: jnp.ndarray, radius: float,
               k: int, chunk: int = 512, method: str = "auto",
               bucket_capacity: int = 64
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (idx (M, K) int32, valid (M, K) bool).

    Slots beyond the neighbor count repeat the first neighbor (standard
    PointNet++ padding so pooled features are unaffected); fully empty
    neighborhoods return valid=False everywhere. ``method``:
    "auto" (dense below BRUTEFORCE_MAX_SOURCE points, hashgrid above),
    "dense", or "hashgrid"."""
    m = queries.shape[0]
    n = points.shape[0]

    if method == "hashgrid" or (method == "auto"
                                and n > BRUTEFORCE_MAX_SOURCE):
        from lidar_crowd.ops import hashgrid as hg
        grid = hg.build_grid(points, pmask, cell_size=radius)
        idx, val = hg.ball_query(grid, queries, qmask, radius, k,
                                 bucket_capacity=bucket_capacity)
        first = idx[:, :1]
        return jnp.where(val, idx, first), val

    r2 = jnp.asarray(radius, points.dtype) ** 2

    int_min = jnp.iinfo(jnp.int32).min

    def chunk_fn(args):
        q, qm = args
        d2 = jnp.sum((q[:, None, :] - points[None, :, :]) ** 2, axis=-1)
        hit = (d2 <= r2) & pmask[None, :] & qm[:, None]
        # first-K-in-scan-order via top_k on a negated-index score:
        # selects exactly the K smallest hit columns
        cols = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[None, :], hit.shape)
        score = jnp.where(hit, -cols, int_min)
        vals, idx = jax.lax.top_k(score, k)
        val = vals != int_min
        idx = jnp.where(val, -vals, 0).astype(jnp.int32)
        # pad empty slots with the first neighbor
        first = idx[:, :1]
        idx = jnp.where(val, idx, first)
        return idx, val

    pad = (-m) % chunk
    qp = jnp.pad(queries, ((0, pad), (0, 0)))
    qm = jnp.pad(qmask, (0, pad))
    steps = (m + pad) // chunk
    if steps == 1:
        idx, val = chunk_fn((qp, qm))
    else:
        idx, val = jax.lax.map(
            chunk_fn, (qp.reshape(steps, chunk, -1),
                       qm.reshape(steps, chunk)))
        idx = idx.reshape(steps * chunk, k)
        val = val.reshape(steps * chunk, k)
    return idx[:m], val[:m]


def group_features(points: jnp.ndarray, features, centroids: jnp.ndarray,
                   idx: jnp.ndarray, valid: jnp.ndarray):
    """Gather grouped relative coordinates (+features) for an SA layer.

    Returns (M, K, 3 [+C]) with invalid slots zeroed."""
    rel = points[idx] - centroids[:, None, :]          # (M, K, 3)
    rel = jnp.where(valid[..., None], rel, 0.0)
    if features is None:
        return rel
    feats = jnp.where(valid[..., None], features[idx], 0.0)
    return jnp.concatenate([rel, feats], axis=-1)


def sa_mlp_pool(grouped: jnp.ndarray, valid: jnp.ndarray,
                weights: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
                compute_dtype=jnp.float32) -> jnp.ndarray:
    """Shared MLP + masked max-pool of one set-abstraction layer.

    grouped: (M, K, Cin); valid: (M, K) bool; weights: [(W, b), ...]
    -> (M, Cout) f32. Each layer feeds ``compute_dtype`` operands to the
    matrix product and accumulates, adds bias and applies ReLU in f32.
    Centroids with no valid neighbor pool to 0."""
    x = grouped.astype(jnp.float32)
    for w, b in weights:
        x = jnp.maximum(
            jnp.dot(x.astype(compute_dtype), w.astype(compute_dtype),
                    preferred_element_type=jnp.float32)
            + b.astype(jnp.float32), 0.0)
    x = jnp.where(valid[..., None], x, -1e9)
    pooled = jnp.max(x, axis=1)
    return jnp.where(jnp.any(valid, axis=1)[:, None], pooled, 0.0)
