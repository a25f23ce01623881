"""Coarse-bucketed radius-count for the density grid.

The monolith reference counts people within radius r of every density
cell centre with a per-cell KD-tree query (app_simplified.py:269-281).
The brute-force device formulation (every cell x every person) is exact
but scales as cells * people — at venue scale (921k cells x ~450k live
people) that is ~3e11 pair tests.

This module exploits that the radius is tiny relative to the venue:
people are bucketed once into a coarse grid whose cell edge is
``s = ceil(radius / grid_size)`` density cells, *sharing the density
grid's origin*. Every person within r of a density-cell centre then
lies in the 3x3 coarse neighborhood of that centre's coarse cell, so
the count is a dense 9 * bucket_cap masked-distance accumulation with
NO gathers: the coarse->fine alignment is a static ``jnp.repeat`` (the
shared origin makes fine cell i map to coarse cell i // s exactly), and
the 3x3 offsets are static slices of the padded table.

Exactness: a person outside the 3x3 window is farther than R >= r from
every point of the centre cell in exact arithmetic, and at least one
f32 ulp beyond r in floating point (coordinates are f32 and R >= r), so
the windowed count equals the brute-force f32 count bit-for-bit. People
dropped because a bucket exceeded ``bucket_cap`` are *counted* in the
returned overflow — the pipeline doubles the capacity and re-runs, the
same exactness contract as the clustering column cap.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

EMPTY_COORD = 1.0e18  # (1e18)^2 < f32 max; always fails d2 <= r2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_people_buckets(xy: jnp.ndarray, mask: jnp.ndarray, origin,
                         coarse_size, cx_cells: int, cy_cells: int,
                         cap: int) -> Tuple[jnp.ndarray, jnp.ndarray,
                                            jnp.ndarray]:
    """Bucket people into (CAP, CX+2, CYP) coordinate planes.

    Returns (tx, ty, overflow): slot-major planes filled with
    EMPTY_COORD where empty (one border cell each side so 3x3 windows
    are static slices), and the number of people dropped by the cap."""
    from lidar_crowd.ops import permute

    k = xy.shape[0]
    cxp = cx_cells + 2
    cyp = _round_up(cy_cells + 2, 128)
    cs = jnp.asarray(coarse_size, xy.dtype)
    ci = jnp.clip(jnp.floor((xy[:, 0] - origin[0]) / cs).astype(jnp.int32),
                  0, cx_cells - 1)
    cj = jnp.clip(jnp.floor((xy[:, 1] - origin[1]) / cs).astype(jnp.int32),
                  0, cy_cells - 1)
    ncells = cxp * cyp
    cid = jnp.where(mask, (ci + 1) * cyp + (cj + 1), ncells)

    # rank within bucket via one sort
    i32 = jnp.arange(k, dtype=jnp.int32)
    order = jnp.argsort(cid).astype(jnp.int32)
    sorted_cid = cid[order]
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]])
    first = jax.lax.cummax(jnp.where(is_start, i32, 0))
    slots = permute.permutation_scatter(order, i32 - first)

    spill = cap * cxp * cyp
    flat = jnp.where(mask & (slots < cap),
                     (slots * cxp + cid // cyp) * cyp + cid % cyp, spill)
    overflow = jnp.sum((mask & (slots >= cap)).astype(jnp.int32))

    tab = jnp.full((spill + 1, 2), EMPTY_COORD, jnp.float32
                   ).at[flat].set(xy.astype(jnp.float32))
    tx = tab[:spill, 0].reshape(cap, cxp, cyp)
    ty = tab[:spill, 1].reshape(cap, cxp, cyp)
    return tx, ty, overflow


def radius_count_bucketed(xy: jnp.ndarray, mask: jnp.ndarray, origin,
                          gx_cap: int, gy_cap: int, grid_size: float,
                          radius: float, bucket_cap: int
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """people-within-radius count per density cell centre, x-major.

    xy: (K, 2) padded people; origin: (2,) density grid lower corner.
    Returns (counts (GX, GY) int32, overflow () int32)."""
    s = -(-int(round(radius / grid_size * 1e6)) // 1_000_000)  # ceil, fp-safe
    s = max(1, s)
    coarse = s * grid_size
    cxc = -(-gx_cap // s)
    cyc = -(-gy_cap // s)
    tx, ty, overflow = build_people_buckets(
        xy, mask, origin, coarse, cxc, cyc, bucket_cap)
    cyp = tx.shape[2]

    g = jnp.asarray(grid_size, jnp.float32)
    r2 = jnp.asarray(radius, jnp.float32) ** 2

    # Fine-cell centres in the coarse-decomposed (I, u) layout: fine cell
    # index I*s + u, centre = origin + (idx + 0.5) * g — the SAME f32
    # expression as the brute paths, so counts bit-match. Padded fine
    # cells past gx_cap are sliced off at the end.
    fxi = jnp.arange(cxc * s, dtype=jnp.float32).reshape(cxc, s)
    fyi = jnp.arange(cyc * s, dtype=jnp.float32).reshape(cyc, s)
    fx = origin[0] + (fxi + 0.5) * g                        # (CXC, s)
    fy = origin[1] + (fyi + 0.5) * g                        # (CYC, s)

    # s^2 x 9 statically-unrolled terms, each one fused (P, CXC, CYC)
    # compare-reduce over the slot axis, with CYC (~venue/coarse) as the
    # minor dimension of every operand.
    planes = []
    for u in range(s):
        for v in range(s):
            acc = jnp.zeros((cxc, cyc), jnp.int32)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    sx = jax.lax.slice(
                        tx, (0, 1 + di, 1 + dj),
                        (bucket_cap, 1 + di + cxc, 1 + dj + cyc))
                    sy = jax.lax.slice(
                        ty, (0, 1 + di, 1 + dj),
                        (bucket_cap, 1 + di + cxc, 1 + dj + cyc))
                    dx = sx - fx[None, :, u, None]   # (P, CXC, CYC)
                    dy = sy - fy[None, None, :, v]
                    acc = acc + jnp.sum(
                        (dx * dx + dy * dy <= r2).astype(jnp.int32),
                        axis=0)
            planes.append(acc)

    # (s*s, CXC, CYC) -> (CXC, s, CYC, s) -> fine grid
    stack = jnp.stack(planes).reshape(s, s, cxc, cyc)
    counts = stack.transpose(2, 0, 3, 1).reshape(cxc * s, cyc * s)
    return counts[:gx_cap, :gy_cap], overflow
