"""CrowdNet — the flagship neural model.

A PointNet++-style hierarchical point-feature encoder with a BEV
(bird's-eye-view) analytics head, per the build target (BASELINE.json
north star: "FPS + ball query + grouping + shared-MLP set abstraction —
the PointNet++ core behind crowd_density_model and crowd_flow_model").
It learns the analytic pipeline's outputs (density map, flow field,
congestion) directly from raw points, replacing the reference's
hand-written grid statistics with a trainable model that runs as one
device program:

  points (N,3) -> SA1 (FPS 2048, r=0.4, K=32, MLP 32-32-64)
              -> SA2 (FPS 512,  r=1.0, K=32, MLP 64-64-128)
              -> BEV scatter-mean of SA1 + SA2 levels
                 ++ raw-point pillar stats (log-count, mean z, max z)
                 ++ coordinate channels (absolute + venue-relative)
              -> conv3x3 trunk
              -> heads: density (G,G) people/m^2 [softplus],
                        flow (G,G,2) m/s,
                        congestion (G,G) 0-1 [sigmoid]

All shapes static; masks carried throughout. Single-example modules are
vmapped by the train step (flax lifted vmap keeps one parameter set).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

try:
    import flax.linen as nn
except ImportError as e:  # optional dependency
    raise ImportError(
        "the neural path (CrowdNet) needs flax, optax and "
        "orbax-checkpoint: pip install 'lidar-crowd[neural]'") from e

from lidar_crowd.ops.grouping import (
    ball_group, group_features, sa_mlp_pool)
from lidar_crowd.ops.sampling import (
    farthest_point_sampling)


class SetAbstraction(nn.Module):
    """One PointNet++ SA layer (single example): farthest-point
    sampling, ball-query grouping, shared MLP + masked max-pool
    (ops/grouping.sa_mlp_pool). FPS indices are a non-differentiable
    selection (argmax contributes no gradient)."""

    n_samples: int
    radius: float
    k: int
    mlp: Sequence[int]
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, points, features, mask):
        idx = farthest_point_sampling(points, mask, self.n_samples)
        centroids = points[idx]                       # (M, 3)
        cmask = mask[idx]
        gidx, gvalid = ball_group(centroids, cmask, points, mask,
                                  self.radius, self.k)
        g = group_features(points, features, centroids, gidx, gvalid)

        cin = g.shape[-1]
        dims = [cin] + list(self.mlp)
        params = []
        for li, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params.append((
                self.param(f"mlp{li}_kernel",
                           nn.initializers.lecun_normal(), (a, b)),
                self.param(f"mlp{li}_bias", nn.initializers.zeros, (b,))))

        # params stay f32; self.dtype (bf16 when configured) feeds the
        # matrix products
        pooled = sa_mlp_pool(g, gvalid, params, compute_dtype=self.dtype)
        pooled = jnp.where(cmask[:, None], pooled, 0.0)
        return centroids, pooled, cmask


def _bev_cells(xy, m, g, venue_min, venue_size):
    rel = (xy - venue_min[None, :]) / venue_size
    cell = jnp.clip((rel * g).astype(jnp.int32), 0, g - 1)
    return jnp.where(m, cell[:, 0] * g + cell[:, 1], g * g)


def _scatter_mean(xy, feats, m, g, venue_min, venue_size):
    """Masked per-cell feature means + counts, (G*G, C) and (G*G,)."""
    flat = _bev_cells(xy, m, g, venue_min, venue_size)
    ones = m.astype(feats.dtype)
    sums = jax.ops.segment_sum(feats * ones[:, None], flat,
                               num_segments=g * g + 1)[:-1]
    cnts = jax.ops.segment_sum(ones, flat,
                               num_segments=g * g + 1)[:-1]
    return sums / jnp.maximum(cnts, 1.0)[:, None], cnts


class BEVHead(nn.Module):
    """Pillarised BEV trunk over three evidence streams.

    Raw-point pillar statistics (log-count, mean z, max z — the
    PointPillars-style hand features that make per-cell density directly
    learnable), multi-scale scattered SA features (SA1 fine + SA2
    context), and coordinate channels (absolute metres + venue-relative)
    so position-dependent targets like the exit-directed flow field are
    expressible by a translation-equivariant conv stack."""

    grid: int
    channels: Sequence[int] = (128, 64)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, levels, points, mask, venue_min, venue_size):
        g = self.grid
        planes = []
        for centroids, features, cmask in levels:
            bev, cnts = _scatter_mean(centroids[:, :2], features, cmask,
                                      g, venue_min, venue_size)
            planes.append(bev.reshape(g, g, -1))
            planes.append((cnts > 0).astype(bev.dtype).reshape(g, g, 1))

        # raw-point pillar stats
        z = points[:, 2:3]
        flat = _bev_cells(points[:, :2], mask, g, venue_min, venue_size)
        ones = mask.astype(z.dtype)
        cnt = jax.ops.segment_sum(ones, flat,
                                  num_segments=g * g + 1)[:-1]
        zsum = jax.ops.segment_sum(z[:, 0] * ones, flat,
                                   num_segments=g * g + 1)[:-1]
        zmax = jax.ops.segment_max(
            jnp.where(mask, z[:, 0], -jnp.inf), flat,
            num_segments=g * g + 1)[:-1]
        live = cnt > 0
        pillar = jnp.stack(
            [jnp.log1p(cnt),
             jnp.where(live, zsum / jnp.maximum(cnt, 1.0), 0.0),
             jnp.where(live, zmax, 0.0)], axis=-1).reshape(g, g, 3)
        planes.append(pillar)

        # coordinate channels: absolute metres (/20) + venue-relative 0-1
        ix = (jnp.arange(g, dtype=jnp.float32) + 0.5) / g
        rx, ry = jnp.meshgrid(ix, ix, indexing="ij")
        cellw = venue_size / g
        ax = (venue_min[0] + rx * g * cellw) * 0.05
        ay = (venue_min[1] + ry * g * cellw) * 0.05
        coords = jnp.stack([rx, ry, ax, ay], axis=-1)
        planes.append(coords)

        h = jnp.concatenate(planes, axis=-1)
        for ch in self.channels:
            h = nn.Conv(ch, (3, 3), padding="SAME", dtype=self.dtype)(h)
            h = nn.relu(h)
        # skip: heads read the pillar evidence and coordinates directly
        # (the conv trunk blurs exactly the per-cell spikes the density
        # head must reproduce)
        return jnp.concatenate(
            [h.astype(jnp.float32), pillar, coords], axis=-1)


class CrowdNet(nn.Module):
    """Full model (single example)."""

    sa1_samples: int = 2048
    sa2_samples: int = 512
    grid: int = 64
    dtype: Any = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, points, mask, venue_min, venue_size):
        SA = nn.remat(SetAbstraction) if self.remat else SetAbstraction
        c1, f1, m1 = SA(self.sa1_samples, 0.4, 32,
                        (32, 32, 64), dtype=self.dtype, name="sa1")(
            points, None, mask)
        c2, f2, m2 = SA(self.sa2_samples, 1.0, 32,
                        (64, 64, 128), dtype=self.dtype, name="sa2")(
            c1, f1, m1)
        h = BEVHead(self.grid, dtype=self.dtype, name="bev")(
            [(c1, f1, m1), (c2, f2, m2)], points, mask,
            venue_min, venue_size)
        # per-cell (1x1) two-layer heads: the hidden layer lets each head
        # threshold the skip-connected pillar stats nonlinearly (e.g.
        # "person cell iff zmax > ~0.5 and count high"). bias_init -3:
        # softplus(-3) ~= 0.05 people/m^2 — the typical mean label — so
        # distillation starts at the no-skill floor instead of
        # softplus(0) = 0.69 predicted everywhere
        def head(name, ch):
            hid = nn.relu(nn.Conv(32, (1, 1), name=f"{name}_hidden")(h))
            return nn.Conv(ch, (1, 1), name=name,
                           bias_init=nn.initializers.constant(
                               -3.0 if name == "density_head" else 0.0)
                           )(hid)

        density = nn.softplus(head("density_head", 1))[..., 0]
        flow = head("flow_head", 2)
        congestion = nn.sigmoid(head("congestion_head", 1))[..., 0]
        # Dedicated count head: a free-form nonnegative mass map whose
        # INTEGRAL is supervised with the true people count (train.py
        # count loss). Decoupled from the density head because the two
        # estimands conflict: per-cell MAE is minimised by the
        # conditional median (sparse, mass-losing), while venue count
        # needs mass preservation — one map cannot serve both (observed:
        # any count pressure on density_head pushes its MAE above the
        # zero floor).
        cmap = nn.softplus(head("count_head", 1))[..., 0]
        cell_area = (venue_size / self.grid) ** 2
        return {"density": density, "flow": flow,
                "congestion": congestion,
                "count": jnp.sum(cmap) * cell_area}


class BatchedCrowdNet(nn.Module):
    """Batch wrapper: one parameter set, vmapped example axis."""

    sa1_samples: int = 2048
    sa2_samples: int = 512
    grid: int = 64
    dtype: Any = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, points, mask, venue_min, venue_size):
        net = nn.vmap(
            CrowdNet,
            in_axes=(0, 0, 0, 0), out_axes=0,
            variable_axes={"params": None},
            split_rngs={"params": False},
        )(self.sa1_samples, self.sa2_samples, self.grid, self.dtype,
          self.remat)
        return net(points, mask, venue_min, venue_size)
