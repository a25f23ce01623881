"""Spatially-sharded venue analytics (shard_map + halo exchange).

The point-cloud analogue of context/sequence parallelism (SURVEY.md §5
long-context): the venue's x-extent is sharded into stripes across the
``sp`` mesh axis. Per-stripe work is dense and local; the only
communication is
  - people positions: small, replicated (they are K << N cluster
    centroids, broadcast once), and
  - stencil halos: the monolith bottleneck rule needs a 2-column x-halo of
    the speed field, exchanged with ``jax.lax.ppermute`` between stripe
    neighbors.

Every sharded op here is *exact* — results bit-match the single-device
path (asserted in tests/test_parallel.py on a virtual CPU mesh).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lidar_crowd.config import PipelineConfig


def _axis_size(mesh: Mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


def sharded_radius_density(people_xy: jnp.ndarray,
                           people_mask: jnp.ndarray,
                           origin: jnp.ndarray, nx, ny,
                           config: PipelineConfig, mesh: Mesh,
                           axis: str = "sp") -> jnp.ndarray:
    """Radius-count density grid with cell stripes sharded over ``axis``.

    people are replicated; each shard counts people within radius of its
    own cell-centre stripe (app_simplified.py:269-281 semantics). Returns
    the full (GX, GY) grid (x-sharded layout)."""
    dc = config.density
    cap = config.capacity
    s = _axis_size(mesh, axis)
    gx, gy = cap.grid_cells_x, cap.grid_cells_y
    assert gx % s == 0, f"grid_cells_x {gx} not divisible by {s} shards"
    local_gx = gx // s
    g = jnp.asarray(dc.grid_size, people_xy.dtype)
    r2 = jnp.asarray(dc.radius, people_xy.dtype) ** 2

    def shard_fn(ppl, pm, org, nx_, ny_):
        sid = jax.lax.axis_index(axis)
        ci = sid * local_gx + jnp.arange(local_gx)
        cj = jnp.arange(gy)
        cx = org[0] + (ci.astype(g.dtype) + 0.5) * g
        cy = org[1] + (cj.astype(g.dtype) + 0.5) * g

        def row(x):
            # one x-row of cell centres against every person: (GY, K)
            # pair tests, never the stripe's (LX, GY, K) at once
            centers = jnp.stack([jnp.broadcast_to(x, cy.shape), cy], -1)
            d2 = jnp.sum((centers[:, None, :] - ppl[None, :, :]) ** 2,
                         axis=-1)
            return jnp.sum((d2 <= r2) & pm[None, :], axis=-1)

        cnt = jax.lax.map(row, cx)
        valid = (ci[:, None] < nx_) & (cj[None, :] < ny_)
        return jnp.where(valid, cnt, 0).astype(g.dtype) / dc.radius_area

    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(axis)))
    return fn(people_xy, people_mask, origin, nx, ny)


def halo_exchange_x(local: jnp.ndarray, halo: int,
                    axis: str) -> jnp.ndarray:
    """Pad a stripe-local array with ``halo`` columns from each x-neighbor
    (zeros at the venue boundary). local: (LX, ...) inside shard_map."""
    n = jax.lax.axis_size(axis)
    right_edge = local[-halo:]
    left_edge = local[:halo]
    # send my right edge to my right neighbor (their left halo), and my
    # left edge to my left neighbor (their right halo); unpaired
    # destinations receive zeros (non-periodic venue boundary)
    from_left = jax.lax.ppermute(
        right_edge, axis, perm=[(i, i + 1) for i in range(n - 1)])
    from_right = jax.lax.ppermute(
        left_edge, axis, perm=[(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([from_left, local, from_right], axis=0)


def sharded_flow_and_bottlenecks(mins: jnp.ndarray, maxs: jnp.ndarray,
                                 uniforms: jnp.ndarray,
                                 config: PipelineConfig, mesh: Mesh,
                                 axis: str = "sp"):
    """Flow synthesis + monolith bottleneck stencil, x-stripe sharded.

    Flow synthesis (crowd_flow_model.py:107-175) is pointwise per node —
    embarrassingly parallel. The bottleneck box rule
    (app_simplified.py:432-446) is a (2*span+1)^2 stencil; the x-halo of
    the speed field is exchanged via ppermute. Returns (vectors (GX,GY,2),
    mags (GX,GY), valid, sev (GX,GY) int32, ok (GX,GY) bool) — identical
    to the single-device models/flow internals."""
    import numpy as np
    fc = config.flow
    cap = config.capacity
    s = _axis_size(mesh, axis)
    gx, gy = cap.grid_cells_x, cap.grid_cells_y
    assert gx % s == 0
    local_gx = gx // s
    span = int(np.ceil(fc.mono_box_halfwidth / fc.grid_size)) - 1

    def shard_fn(mn, mx, u):
        dt = mn.dtype
        sid = jax.lax.axis_index(axis)
        g = jnp.asarray(fc.grid_size, dt)
        x0, x1 = mn[0], mx[0]
        y0, y1 = mn[1], mx[1]
        nx = jnp.clip(jnp.ceil((x1 + g - x0) / g).astype(jnp.int32), 1, gx)
        ny = jnp.clip(jnp.ceil((y1 + g - y0) / g).astype(jnp.int32), 1, gy)

        gi = sid * local_gx + jnp.arange(local_gx)
        jj = jnp.arange(gy, dtype=dt)
        px = jnp.broadcast_to((x0 + gi.astype(dt) * g)[:, None],
                              (local_gx, gy))
        py = jnp.broadcast_to((y0 + jj * g)[None, :], (local_gx, gy))
        valid = (gi[:, None] < nx) & (jnp.arange(gy)[None, :] < ny)

        exit_x, exit_y = x1, (y0 + y1) / 2
        dx, dy = exit_x - px, exit_y - py
        dist = jnp.sqrt(dx * dx + dy * dy)
        nz = dist > 0
        ux = jnp.where(nz, dx / jnp.where(nz, dist, 1.0), 0.0)
        uy = jnp.where(nz, dy / jnp.where(nz, dist, 1.0), 0.0)
        ang = (jnp.sin(px * fc.swirl_complexity)
               * jnp.cos(py * fc.swirl_complexity) * fc.swirl_amplitude)
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        vx = ux * ca - uy * sa
        vy = ux * sa + uy * ca
        for b in range(u.shape[0]):
            bx = x0 + 1 + u[b, 0] * (x1 - x0 - 2)
            by = y0 + 1 + u[b, 1] * (y1 - y0 - 2)
            d = jnp.sqrt((px - bx) ** 2 + (py - by) ** 2)
            damp = jnp.where(d < fc.bottleneck_radius,
                             d / fc.bottleneck_radius, 1.0)
            vx, vy = vx * damp, vy * damp
        mags = jnp.sqrt(vx * vx + vy * vy)

        # global max for the speed rescale: psum of per-shard max is wrong;
        # use pmax over the mesh axis
        mmax = jax.lax.pmax(jnp.max(jnp.where(valid, mags, 0.0)), axis)
        scale = jnp.where(mmax > 0, fc.monolith_max_speed / mmax, 1.0)
        # same arithmetic as models/flow.synthesize_flow: the speeds are
        # recomputed from the scaled vectors, so they match bit for bit
        vx, vy = vx * scale, vy * scale
        mags = jnp.sqrt(vx * vx + vy * vy)

        # bottleneck stencil with x-halo exchange
        mags_h = halo_exchange_x(jnp.where(valid, mags, 0.0), span, axis)
        valid_h = halo_exchange_x(valid, span, axis)
        box_max = jnp.zeros_like(mags)
        for ddx in range(-span, span + 1):
            for ddy in range(-span, span + 1):
                xs = span + ddx
                seg = jax.lax.dynamic_slice_in_dim(mags_h, xs, local_gx, 0)
                vseg = jax.lax.dynamic_slice_in_dim(valid_h, xs, local_gx,
                                                    0)
                if ddy > 0:
                    seg = jnp.pad(seg[:, ddy:], ((0, 0), (0, ddy)))
                    vseg = jnp.pad(vseg[:, ddy:], ((0, 0), (0, ddy)))
                elif ddy < 0:
                    seg = jnp.pad(seg[:, :ddy], ((0, 0), (-ddy, 0)))
                    vseg = jnp.pad(vseg[:, :ddy], ((0, 0), (-ddy, 0)))
                box_max = jnp.maximum(box_max, jnp.where(vseg, seg, 0.0))

        slow = valid & (mags < fc.mono_slow_speed)
        fast_near = box_max > fc.mono_fast_speed
        sev = jnp.minimum(10, jnp.floor(
            10.0 * (box_max - mags)
            / jnp.maximum(box_max, 1e-12))).astype(jnp.int32)
        ok = slow & fast_near & (sev >= fc.mono_min_severity)
        vectors = jnp.where(valid[..., None],
                            jnp.stack([vx, vy], axis=-1), 0.0)
        return vectors, jnp.where(valid, mags, 0.0), valid, sev, ok

    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis))))
    return fn(mins, maxs, uniforms)
