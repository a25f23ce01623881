"""Crowd-flow analytics on device.

Device re-design of models/crowd_flow_model.py (modular) and
app_simplified.py:318-464 (monolith). The reference's flow field is a
deterministic synthesis (no temporal data): unit vectors toward an exit at
the right-edge midpoint, a sinusoidal swirl rotation, and three seeded
random bottleneck discs that damp speed. All of it is embarrassingly
parallel — the reference's per-node Python loops
(crowd_flow_model.py:125-165) become pure vectorised jnp over a static
(GX, GY) node lattice with validity masks.

Bottleneck detection exploits the lattice structure: the reference's
KD-tree radius queries over *regular 1 m grid nodes*
(crowd_flow_model.py:205-263) are exactly fixed-offset stencils, so both
variants are implemented as unrolled masked-shift stencil reductions — no
neighbor search at all, and the convergence dot-products reduce to
constants per offset.

Randomness: the three bottleneck disc centres consume exactly six
np.random.uniform draws after np.random.seed(42)
(crowd_flow_model.py:100,151-154). The raw U(0,1) draws are data, not
compute — they are precomputed host-side once (`bottleneck_uniforms`) and
mapped to venue coordinates on device, keeping the jitted function free of
host RNG while matching the reference stream bit-for-bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lidar_crowd.config import PipelineConfig
from lidar_crowd.types import (
    FlowResults, People, ProcessedCloud)


def bottleneck_uniforms(seed: int = 42, count: int = 3) -> np.ndarray:
    """The (count, 2) raw U(0,1) draws the reference consumes for
    bottleneck centres (x then y per bottleneck, in order)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(size=(count, 2))


def _shift(a: jnp.ndarray, dx: int, dy: int, fill=0.0) -> jnp.ndarray:
    """out[i, j] = a[i+dx, j+dy], `fill` outside — static-offset shift."""
    gx, gy = a.shape[:2]
    pad = [(max(0, -dx), max(0, dx)), (max(0, -dy), max(0, dy))]
    pad += [(0, 0)] * (a.ndim - 2)
    ap = jnp.pad(a, pad, constant_values=fill)
    return jax.lax.slice(
        ap, (max(0, dx), max(0, dy)) + (0,) * (a.ndim - 2),
        (max(0, dx) + gx, max(0, dy) + gy) + a.shape[2:])


def _disc_offsets(r2_min: float, r2_max: float, rmax: int):
    """Static offsets (dx, dy) with r2_min < dx^2+dy^2 <= r2_max."""
    out = []
    for dx in range(-rmax, rmax + 1):
        for dy in range(-rmax, rmax + 1):
            d2 = dx * dx + dy * dy
            if r2_min < d2 <= r2_max:
                out.append((dx, dy))
    return out


def synthesize_flow(processed: ProcessedCloud, uniforms: jnp.ndarray,
                    config: PipelineConfig):
    """Deterministic flow field over the venue lattice.

    Returns (vectors (GX,GY,2), mags (GX,GY), node_valid (GX,GY),
    nx, ny) in x-major layout. Node (i,j) sits at (x0+i*g, y0+j*g) —
    np.arange(x0, x1+g, g) lattice (crowd_flow_model.py:107-111)."""
    fc = config.flow
    cap = config.capacity
    dt = processed.points.dtype
    g = jnp.asarray(fc.grid_size, dt)
    x0, x1 = processed.mins[0], processed.maxs[0]
    y0, y1 = processed.mins[1], processed.maxs[1]

    nx = jnp.clip(jnp.ceil((x1 + g - x0) / g).astype(jnp.int32),
                  1, cap.grid_cells_x)
    ny = jnp.clip(jnp.ceil((y1 + g - y0) / g).astype(jnp.int32),
                  1, cap.grid_cells_y)

    ii = jnp.arange(cap.grid_cells_x, dtype=dt)
    jj = jnp.arange(cap.grid_cells_y, dtype=dt)
    px = x0 + ii[:, None] * g                       # (GX, 1)
    py = y0 + jj[None, :] * g                       # (1, GY)
    px = jnp.broadcast_to(px, (cap.grid_cells_x, cap.grid_cells_y))
    py = jnp.broadcast_to(py, (cap.grid_cells_x, cap.grid_cells_y))
    valid = (jnp.arange(cap.grid_cells_x)[:, None] < nx) & \
            (jnp.arange(cap.grid_cells_y)[None, :] < ny)

    # Base field toward exit at right-edge midpoint
    # (crowd_flow_model.py:119-121).
    exit_x, exit_y = x1, (y0 + y1) / 2
    dx = exit_x - px
    dy = exit_y - py
    dist = jnp.sqrt(dx * dx + dy * dy)
    nzero = dist > 0
    ux = jnp.where(nzero, dx / jnp.where(nzero, dist, 1.0), 0.0)
    uy = jnp.where(nzero, dy / jnp.where(nzero, dist, 1.0), 0.0)

    # Swirl rotation (crowd_flow_model.py:137-146).
    ang = (jnp.sin(px * fc.swirl_complexity)
           * jnp.cos(py * fc.swirl_complexity) * fc.swirl_amplitude)
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    vx = ux * ca - uy * sa
    vy = ux * sa + uy * ca

    # Bottleneck discs damp speed (crowd_flow_model.py:151-165). The
    # uniforms are the reference's exact seeded draws; centres live in
    # [lo+1, hi-1].
    u = uniforms.astype(dt)
    for b in range(u.shape[0]):
        bx = x0 + 1 + u[b, 0] * (x1 - x0 - 2)
        by = y0 + 1 + u[b, 1] * (y1 - y0 - 2)
        d = jnp.sqrt((px - bx) ** 2 + (py - by) ** 2)
        damp = jnp.where(d < fc.bottleneck_radius,
                         d / fc.bottleneck_radius, 1.0)
        vx = vx * damp
        vy = vy * damp

    mags = jnp.sqrt(vx * vx + vy * vy)
    mmax = jnp.max(jnp.where(valid, mags, 0.0))

    if fc.scale_mode == "monolith":
        # scale so max speed == 1.3 (app_simplified.py:409)
        scale = jnp.where(mmax > 0, fc.monolith_max_speed / mmax, 1.0)
        vx, vy = vx * scale, vy * scale
        mags = jnp.sqrt(vx * vx + vy * vy)
    else:
        # modular: scale by (max-min)/mmax then clip magnitudes
        # (crowd_flow_model.py:171-175). NB the clip applies to magnitudes
        # only; vectors keep the pre-clip scaling, as in the reference.
        scale = jnp.where(mmax > 0,
                          (fc.speed_max - fc.speed_min) / mmax, 1.0)
        vx, vy = vx * scale, vy * scale
        mags = jnp.clip(jnp.sqrt(vx * vx + vy * vy),
                        fc.speed_min, fc.speed_max)

    vectors = jnp.stack([vx, vy], axis=-1)
    vectors = jnp.where(valid[..., None], vectors, 0.0)
    mags = jnp.where(valid, mags, 0.0)
    return vectors, mags, valid, nx, ny


def _bottlenecks_monolith(mags, valid, config: PipelineConfig):
    """app_simplified.py:430-449: nodes with speed < 0.3 whose 3x3 m box
    (offsets -2..2 on the 1 m lattice, strict |d|<3) contains a node faster
    than 0.5; severity = int(10*(max-mag)/max), keep >= 3."""
    fc = config.flow
    span = int(np.ceil(fc.mono_box_halfwidth / fc.grid_size)) - 1
    box_max = jnp.zeros_like(mags)
    for dx in range(-span, span + 1):
        for dy in range(-span, span + 1):
            shifted = jnp.where(_shift(valid, dx, dy, False),
                                _shift(mags, dx, dy, 0.0), 0.0)
            box_max = jnp.maximum(box_max, shifted)
    slow = valid & (mags < fc.mono_slow_speed)
    fast_near = box_max > fc.mono_fast_speed
    sev = jnp.floor(10.0 * (box_max - mags)
                    / jnp.maximum(box_max, 1e-12)).astype(jnp.int32)
    sev = jnp.minimum(10, sev)
    ok = slow & fast_near & (sev >= fc.mono_min_severity)
    return sev, ok


def _bottlenecks_modular(vectors, mags, valid, config: PipelineConfig):
    """crowd_flow_model.py:210-271 as stencils on the 1 m lattice:
    near = r<=3 disc (29 offsets incl. centre), far = 3<r<=5 ring;
    severity = ((mean_far-mean_near)*5 + convergence*5)/2 > 1. The
    convergence unit direction from neighbor to centre is the constant
    -off/|off| per offset."""
    fc = config.flow
    near_offs = _disc_offsets(-1.0, fc.mod_near_radius ** 2,
                              int(fc.mod_near_radius))
    far_offs = _disc_offsets(fc.mod_near_radius ** 2,
                             fc.mod_far_radius ** 2, int(fc.mod_far_radius))
    dt = mags.dtype

    n_near = jnp.zeros_like(mags)
    s_near = jnp.zeros_like(mags)
    conv = jnp.zeros_like(mags)
    for dx, dy in near_offs:
        v = _shift(valid, dx, dy, False)
        n_near += v.astype(dt)
        s_near += jnp.where(v, _shift(mags, dx, dy), 0.0)
        if dx or dy:
            norm = float(np.sqrt(dx * dx + dy * dy))
            ux, uy = -dx / norm, -dy / norm
            nv = _shift(vectors, dx, dy)
            dot = ux * nv[..., 0] + uy * nv[..., 1]
            conv += jnp.where(v, jnp.maximum(0.0, dot), 0.0)

    n_far = jnp.zeros_like(mags)
    s_far = jnp.zeros_like(mags)
    for dx, dy in far_offs:
        v = _shift(valid, dx, dy, False)
        n_far += v.astype(dt)
        s_far += jnp.where(v, _shift(mags, dx, dy), 0.0)

    mean_near = s_near / jnp.maximum(n_near, 1.0)
    mean_far = s_far / jnp.maximum(n_far, 1.0)
    grad = mean_far - mean_near
    conv = conv / jnp.maximum(n_near, 1.0)
    sev_f = (grad * 5.0 + conv * 5.0) / 2.0
    sev = jnp.minimum(10, jnp.round(sev_f)).astype(jnp.int32)
    ok = (valid & (mags <= fc.mod_slow_speed)
          & (n_near >= fc.mod_min_near) & (n_far >= fc.mod_min_far)
          & (sev_f > fc.mod_min_severity))
    return sev, ok


def analyze_flow(processed: ProcessedCloud, people: People,
                 uniforms: jnp.ndarray,
                 config: PipelineConfig) -> FlowResults:
    fc = config.flow
    cap = config.capacity
    dt = processed.points.dtype

    vectors, mags, valid, nx, ny = synthesize_flow(processed, uniforms,
                                                   config)
    vcount = jnp.maximum(jnp.sum(valid.astype(dt)), 1.0)
    avg_speed = jnp.sum(jnp.where(valid, mags, 0.0)) / vcount
    mean_vec = jnp.sum(jnp.where(valid[..., None], vectors, 0.0),
                       axis=(0, 1)) / vcount

    if fc.variant == "monolith":
        sev, ok = _bottlenecks_monolith(mags, valid, config)
    else:
        sev, ok = _bottlenecks_modular(vectors, mags, valid, config)

    # Reference iterates nodes y-outer (meshgrid ravel), sorts stable by
    # severity desc — replicate via transpose + stable top_k.
    sev_flat = sev.T.reshape(-1)
    ok_flat = ok.T.reshape(-1)
    g = jnp.asarray(fc.grid_size, dt)
    x0, y0 = processed.mins[0], processed.mins[1]
    ii = jnp.arange(cap.grid_cells_x, dtype=dt)
    jj = jnp.arange(cap.grid_cells_y, dtype=dt)
    px = jnp.broadcast_to((x0 + ii * g)[:, None],
                          (cap.grid_cells_x, cap.grid_cells_y))
    py = jnp.broadcast_to((y0 + jj * g)[None, :],
                          (cap.grid_cells_x, cap.grid_cells_y))
    fx = px.T.reshape(-1)
    fy = py.T.reshape(-1)

    scores = jnp.where(ok_flat, sev_flat, -1)
    top_v, top_i = jax.lax.top_k(scores, fc.max_bottlenecks)
    bmask = top_v >= 0

    # Empty-people semantics (crowd_flow_model.py:42-52).
    empty = people.count == 0
    bmask = bmask & ~empty
    node_mask_flat = valid.T.reshape(-1) & ~empty

    return FlowResults(
        positions=jnp.stack([fx, fy], axis=1),
        vectors=vectors.transpose(1, 0, 2).reshape(-1, 2),
        magnitudes=mags.T.reshape(-1),
        node_mask=node_mask_flat,
        avg_speed=jnp.where(empty, 0.0, avg_speed),
        mean_vector=jnp.where(empty, jnp.zeros_like(mean_vec), mean_vec),
        bottleneck_xy=jnp.stack([fx[top_i], fy[top_i]], axis=1),
        bottleneck_severity=jnp.where(bmask, top_v, 0),
        bottleneck_mask=bmask)
