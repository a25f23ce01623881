"""Core pytree data structures.

The reference passes Python dicts of dynamically-shaped NumPy arrays between
stages (e.g. ``processed_data`` in utils/data_processing.py:220-227 and the
results dicts in models/crowd_density_model.py:88-96 /
crowd_flow_model.py:79-84). Everything under ``jit`` must have static
shapes, so each stage instead exchanges fixed-capacity padded tensors plus
validity masks, wrapped in frozen dataclasses registered as pytrees
(``pytree_dataclass``) — they flow through jit/vmap/shard_map
transparently.

Host-facing result dicts (matching the reference's shapes) are produced by
the ``to_host_dict`` helpers at the pipeline boundary only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


def pytree_dataclass(cls):
    """Frozen dataclass whose fields are all pytree leaves; copy with
    ``dataclasses.replace``."""
    return jax.tree_util.register_dataclass(
        dataclasses.dataclass(frozen=True)(cls))


@pytree_dataclass
class PointCloud:
    """A fixed-capacity padded point cloud.

    points: (N, 3) float — xyz; rows past ``count`` are padding.
    mask:   (N,)   bool  — True for valid points.
    """

    points: Array
    mask: Array

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def count(self) -> Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    @classmethod
    def from_numpy(cls, pts: np.ndarray, capacity: Optional[int] = None,
                   dtype=jnp.float32) -> "PointCloud":
        pts = np.asarray(pts, dtype=np.float32)[:, :3]
        n = pts.shape[0]
        cap = capacity or n
        if n > cap:
            raise ValueError(f"point count {n} exceeds capacity {cap}")
        buf = np.zeros((cap, 3), dtype=np.float32)
        buf[:n] = pts
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return cls(points=jnp.asarray(buf, dtype=dtype),
                   mask=jnp.asarray(mask))


@pytree_dataclass
class ProcessedCloud:
    """Output of preprocessing — the device analogue of the reference's
    ``processed_data`` dict (utils/data_processing.py:220-227).

    All arrays have static shapes; ``mask`` marks surviving inlier points.
    ``labels`` uses the reference's convention: -1 = ground/noise, >=0 =
    person-cluster id (ids are dense 0..n_clusters-1 in first-point order).
    """

    points: Array        # (N, 3)  inlier points (padded)
    mask: Array          # (N,)    valid & inlier
    colors: Array        # (N, 3)  height-ramp RGB
    normals: Array       # (N, 3)  synthetic up normals
    labels: Array        # (N,)    int32 cluster labels, -1 ground/noise
    ground_mask: Array   # (N,)    True where point classified as ground
    ground_plane: Array  # (4,)    [a, b, c, d] for ax+by+cz+d=0
    mins: Array          # (3,)    inlier bbox minimum
    maxs: Array          # (3,)    inlier bbox maximum
    n_clusters: Array    # ()      int32 number of person clusters
    cluster_overflow: Array  # ()  int32 points dropped by column-cap
                             #     overflow (0 => clustering is exact)

    @property
    def dimensions(self) -> Dict[str, Any]:
        """Host-side dimensions dict in the reference layout
        (utils/data_processing.py:210-217)."""
        mins = np.asarray(self.mins)
        maxs = np.asarray(self.maxs)
        return {
            "x_range": (float(mins[0]), float(maxs[0])),
            "y_range": (float(mins[1]), float(maxs[1])),
            "z_range": (float(mins[2]), float(maxs[2])),
            "width": float(maxs[0] - mins[0]),
            "length": float(maxs[1] - mins[1]),
            "height": float(maxs[2] - mins[2]),
        }


@pytree_dataclass
class People:
    """Per-cluster centroids — analogue of extract_people_positions
    (utils/data_processing.py:251-280), padded to capacity K.

    ``z`` keeps the centroid height: density/flow only use xy (reference
    semantics) but temporal tracking filters person-like clusters by
    height to reject ground-hugging pseudo-clusters.

    ``overflow`` counts clusters dropped because their dense id exceeded
    the static capacity K — nonzero means ``count`` undercounts and the
    pipeline must regrow ``max_people`` and re-run (the reference's
    extract_people_positions never drops a cluster)."""

    positions: Array   # (K, 2) xy centroids
    mask: Array        # (K,)   valid people
    z: Array           # (K,)   centroid heights
    overflow: Array = 0  # () int32 clusters dropped

    @property
    def count(self) -> Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    def person_like(self, min_height: float,
                    ground_z: Array) -> "People":
        """Subset whose centroid sits at least ``min_height`` above the
        venue floor."""
        keep = self.mask & (self.z - ground_z > min_height)
        return People(positions=self.positions, mask=keep, z=self.z,
                      overflow=self.overflow)


@pytree_dataclass
class DensityResults:
    """Density analysis — analogue of crowd_density_model.py:88-96.

    The density grid has static capacity (GX, GY); ``nx``/``ny`` give the
    dynamic number of valid cells, and cell (i, j) covers
    [origin + i*g, origin + (i+1)*g) etc.
    """

    total_people: Array      # ()    int32
    avg_density: Array       # ()    float
    max_density: Array       # ()    float
    density_grid: Array      # (GX, GY) float, people/m^2 (x-major)
    origin: Array            # (2,)  xy of grid cell (0,0) lower corner
    nx: Array                # ()    int32 valid cells in x
    ny: Array                # ()    int32 valid cells in y
    hotspot_xy: Array        # (H, 2) hotspot cell-centre xy
    hotspot_density: Array   # (H,)  hotspot densities (desc)
    hotspot_mask: Array      # (H,)  valid hotspots
    radius_overflow: Array = 0  # () int32 people dropped by the bucketed
    #                             radius count (0 = grid exact); the
    #                             pipeline doubles density_bucket_cap and
    #                             re-runs on overflow

    def to_host_dict(self) -> Dict[str, Any]:
        """Reference-shaped results dict (crowd_density_model.py:88-96)."""
        nx = int(self.nx)
        ny = int(self.ny)
        grid = np.asarray(self.density_grid)[:nx, :ny]
        hmask = np.asarray(self.hotspot_mask)
        hxy = np.asarray(self.hotspot_xy)
        hd = np.asarray(self.hotspot_density)
        hotspots = [
            {"x": float(hxy[i, 0]), "y": float(hxy[i, 1]),
             "density": float(hd[i])}
            for i in range(len(hmask)) if hmask[i]
        ]
        origin = np.asarray(self.origin)
        g = grid  # x-major: grid[i, j] at x=origin[0]+(i+.5)*cell
        return {
            "total_people": int(self.total_people),
            "avg_density": float(self.avg_density),
            "max_density": float(self.max_density),
            "density_map": g,
            "density_grid": g.T,  # reference monolith stores [j, i] (y-major)
            "origin": (float(origin[0]), float(origin[1])),
            "hotspots": hotspots,
        }


@pytree_dataclass
class FlowResults:
    """Flow analysis — analogue of crowd_flow_model.py:79-84."""

    positions: Array        # (G, 2) flow grid node xy (padded, x-major flat)
    vectors: Array          # (G, 2) flow vectors (m/s)
    magnitudes: Array       # (G,)   speeds
    node_mask: Array        # (G,)   valid nodes
    avg_speed: Array        # ()     float
    mean_vector: Array      # (2,)   mean of vectors over valid nodes
    bottleneck_xy: Array    # (B, 2)
    bottleneck_severity: Array  # (B,) int32
    bottleneck_mask: Array  # (B,)

    def dominant_direction(self) -> str:
        """8-way compass of the mean flow vector
        (crowd_flow_model.py:65-74)."""
        v = np.asarray(self.mean_vector)
        if not np.any(np.asarray(self.node_mask)):
            return "N/A"
        angle = float(np.arctan2(v[1], v[0]) * 180.0 / np.pi)
        directions = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]
        idx = int((angle + 22.5) % 360 / 45)
        return directions[idx]

    def to_host_dict(self) -> Dict[str, Any]:
        m = np.asarray(self.node_mask)
        bm = np.asarray(self.bottleneck_mask)
        bxy = np.asarray(self.bottleneck_xy)
        bs = np.asarray(self.bottleneck_severity)
        return {
            "avg_speed": float(self.avg_speed),
            "dominant_direction": self.dominant_direction(),
            "bottlenecks": [
                {"x": float(bxy[i, 0]), "y": float(bxy[i, 1]),
                 "severity": int(bs[i])}
                for i in range(len(bm)) if bm[i]
            ],
            "flow_vectors": {
                "positions": np.asarray(self.positions)[m],
                "vectors": np.asarray(self.vectors)[m],
                "magnitudes": np.asarray(self.magnitudes)[m],
            },
        }


@pytree_dataclass
class AnalysisResults:
    """Full pipeline output (device side)."""

    density: DensityResults
    flow: FlowResults
