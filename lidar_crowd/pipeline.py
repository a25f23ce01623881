"""End-to-end analytics pipeline.

One jitted device program runs preprocess -> people extraction -> density ->
flow (the reference spreads this across Streamlit button handlers,
app.py:197-258); the host only converts the fixed-capacity device results
into reference-shaped dicts and runs the rule-based recommendation engine.

Usage:
    pipe = Pipeline(MONOLITH_CONFIG)
    results = pipe.analyze(points_np)          # full host-facing dicts
    device_res = pipe.analyze_device(cloud)    # stays on device (bench path)
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lidar_crowd.config import (
    MONOLITH_CONFIG, PipelineConfig)
from lidar_crowd.models import density as density_mod
from lidar_crowd.models import flow as flow_mod
from lidar_crowd.preprocess import preprocess
from lidar_crowd.types import (
    AnalysisResults, People, PointCloud, ProcessedCloud)
from lidar_crowd.utils.recommendations import (
    generate_recommendations)


@functools.partial(jax.jit, static_argnames=("config",))
def analyze_cloud(cloud: PointCloud, uniforms: jnp.ndarray,
                  config: PipelineConfig) -> tuple:
    """The full device program: static config, static shapes, one XLA
    compilation."""
    processed = preprocess(cloud, config)
    people = density_mod.extract_people(processed, config)
    dres = density_mod.analyze_density(processed, people, config)
    fres = flow_mod.analyze_flow(processed, people, uniforms, config)
    return processed, people, AnalysisResults(density=dres, flow=fres)


@functools.partial(jax.jit, static_argnames=("config",))
def people_of_cloud(cloud: PointCloud, config: PipelineConfig) -> tuple:
    """Tracking-only device program: preprocess + people extraction,
    skipping the density/flow stages — what each non-final frame of a
    sequence needs (analyze_sequence). Same static-capacity contract as
    analyze_cloud."""
    processed = preprocess(cloud, config)
    people = density_mod.extract_people(processed, config)
    return processed, people


def _bucket_eighth_octave(n: int, floor: int = 64) -> int:
    """Smallest multiple of 2^(k-3) >= n, where 2^(k-1) < n <= 2^k.

    Keeps capacities aligned (the step is itself a large power of two)
    while capping padding waste at 12.5% — a next-power-of-two rule
    would pad a 10M-point cloud to 16.78M."""
    n = max(int(n), floor)
    k = (n - 1).bit_length()
    step = 1 << max(k - 3, 3)
    return -(-n // step) * step


# The checkout that holds this package; the compile cache lives in it
# when JAX_COMPILATION_CACHE_DIR is unset.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """Where compiled programs persist: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``.jax_cache`` in the checkout (listed in
    .gitignore). The path is part of each entry's key, so it is fixed,
    never derived from a temp dir, a pid or a time."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> None:
    """Persist compiled programs across processes on an accelerator,
    where a venue-scale compile costs far more than a cache read. The
    CPU backend is left alone: its entries carry host machine features
    that can differ between processes (XLA warns of SIGILL), and CPU
    compiles are cheap."""
    if jax.default_backend() == "cpu":
        return
    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())


class Pipeline:
    """Host-facing orchestrator with reference-shaped outputs."""

    def __init__(self, config: PipelineConfig = MONOLITH_CONFIG):
        enable_compilation_cache()
        self.config = config
        self._uniforms = jnp.asarray(
            flow_mod.bottleneck_uniforms(config.flow.random_seed,
                                         config.flow.bottleneck_count),
            dtype=jnp.float32)

    def fit_capacity(self, points: np.ndarray) -> PipelineConfig:
        """Size static capacities to the input (bucketed so jit
        recompiles are rare): point capacity covers n, the density/flow
        grid covers the venue extent, and the people capacity scales
        with point count. Point/people capacities bucket to EIGHTHS of
        an octave (multiples of 2^(k-3) within [2^(k-1), 2^k]) rather
        than powers of two: a 10M cloud pads to 10.49M instead of
        16.78M, for at most 8 distinct compiles per octave."""
        cap = self.config.capacity
        n = len(points)
        max_points = max(cap.max_points, _bucket_eighth_octave(n))

        mins = points.min(axis=0)
        maxs = points.max(axis=0)
        g = self.config.density.grid_size
        margin = 2 * self.config.density.margin_cells + 2
        need_x = int(np.ceil((maxs[0] - mins[0]) / g)) + margin
        need_y = int(np.ceil((maxs[1] - mins[1]) / g)) + margin

        def bucket32(v, lo):
            return max(lo, ((v + 31) // 32) * 32)

        gx = bucket32(need_x, cap.grid_cells_x)
        gy = bucket32(need_y, cap.grid_cells_y)
        max_people = max(cap.max_people,
                         _bucket_eighth_octave(max(1, n // 8), floor=32))

        # Cluster column grid: aim for eps-sized columns, bounded so the
        # dense table stays HBM-friendly; cells auto-grow past the bound
        # (ops/columns.py) and the overflow diagnostic guards exactness.
        # Pair-test work is ncells * 9 * column_cap^2, so prefer FINE cells
        # with a SMALL per-column cap sized to expected occupancy (the
        # pipeline's overflow auto-retry doubles the cap on adversarial
        # scenes, trading a recompile for exactness).
        eps = self.config.preprocess.dbscan_eps
        ccx = bucket32(min(int((maxs[0] - mins[0]) / eps) + 2, 1280),
                       cap.cluster_cells_x)
        ccy = bucket32(min(int((maxs[1] - mins[1]) / eps) + 2, 1280),
                       cap.cluster_cells_y)

        # clustering buffer: ~70% of points are non-ground; next pow2 of
        # 0.8n leaves headroom, the overflow auto-retry covers the rest
        ccap = 1 << max(10, (max(1, int(0.8 * n)) - 1).bit_length())
        ccap = min(ccap, max_points)

        def ceil8(v):
            return ((int(v) + 7) // 8) * 8

        # Occupancy-MEASURED column cap: pair-test work per CCL sweep is
        # ncells * 9 * cap^2, so cap is the single biggest lever (a 2x
        # over-allocation costs 4x). One host-side bincount of the cells
        # the device grid will use gives the exact max occupancy; +3
        # headroom absorbs the slightly different extent of the
        # non-ground subset the device actually clusters (a subset can
        # only lower occupancy for identical binning; the margin covers
        # binning shifts, and the overflow auto-retry guards exactness).
        if n > 32768:  # column path only (small sets are brute-forced)
            cell = max(eps, (maxs[:2] - mins[:2]).max() / (min(ccx, ccy)
                                                           - 1e-3))
            cxi = np.clip(((points[:, 0] - mins[0]) / cell).astype(
                np.int64), 0, ccx - 1)
            cyi = np.clip(((points[:, 1] - mins[1]) / cell).astype(
                np.int64), 0, ccy - 1)
            max_occ = int(np.bincount(cxi * ccy + cyi).max())
            ccol = min(64, max(8, ceil8(max_occ + 3)))
        else:
            occ = 0.8 * n / float(ccx * ccy)
            ccol = min(64, max(16, ceil8(8.0 * occ + 8.0)))
            ccol = max(ccol, cap.cluster_column_cap)

        if (max_points == cap.max_points and gx == cap.grid_cells_x
                and gy == cap.grid_cells_y
                and max_people == cap.max_people
                and ccx == cap.cluster_cells_x
                and ccy == cap.cluster_cells_y
                and ccap == cap.cluster_capacity
                and ccol == cap.cluster_column_cap):
            return self.config
        return self.config.with_capacity(
            max_points=max_points, grid_cells_x=gx, grid_cells_y=gy,
            max_people=max_people, cluster_cells_x=ccx,
            cluster_cells_y=ccy, cluster_capacity=ccap,
            cluster_column_cap=ccol)

    def analyze_device(self, cloud: PointCloud,
                       config: Optional[PipelineConfig] = None):
        cfg = config or self.config
        return analyze_cloud(cloud, self._uniforms, cfg)

    # Beyond this coordinate magnitude, f32 cell/cluster math loses the
    # sub-metre resolution the analytics need (real-world LAS files often
    # carry UTM offsets ~1e5-1e7); recentre on device ingest and shift the
    # reported coordinates back on the host.
    RECENTER_THRESHOLD = 4096.0

    def _grown_cluster_cfg(self, cfg: PipelineConfig
                           ) -> Optional[PipelineConfig]:
        """Double the clustering capacities after an overflow. Returns
        None when both knobs sit at their ceiling — column cap 512 and a
        buffer at max_points, or at the brute-force HBM wall for the
        modular variant (BRUTEFORCE_HARD_CAP: eps = 0.5 sigma in
        standardized space admits no exact spatial decomposition, and
        the packed adjacency is cap^2/8 bytes)."""
        from lidar_crowd.ops import clustering
        cap_limit = cfg.capacity.max_points
        if self.config.preprocess.variant == "modular":
            cap_limit = min(cap_limit, clustering.BRUTEFORCE_HARD_CAP)
        if (cfg.capacity.cluster_column_cap >= 512
                and cfg.capacity.cluster_capacity >= cap_limit):
            return None
        return cfg.with_capacity(
            cluster_column_cap=min(512,
                                   cfg.capacity.cluster_column_cap * 2),
            cluster_capacity=min(cap_limit,
                                 max(1, cfg.capacity.cluster_capacity)
                                 * 2))

    _OVERFLOW_MSG = (
        "clustering overflowed its exact-capacity ceiling ({n} points "
        "dropped). The modular variant clusters StandardScaler-warped "
        "space where eps=0.5 is macroscopic, so only the O(n^2) packed "
        "brute force is exact and it is HBM-bounded at 131072 non-ground "
        "points (the reference's sklearn path hits MemoryError at the "
        "same scale, utils/data_processing.py:197). Downsample first "
        "(ops/sampling.random_downsample) or use the monolith variant.")

    def analyze(self, points: np.ndarray) -> Dict:
        """NumPy points in, reference-shaped result dicts out."""
        points = np.asarray(points, dtype=np.float64)[:, :3]
        offset = np.zeros(3)
        if np.abs(points[:, :2]).max() > self.RECENTER_THRESHOLD:
            offset[:2] = np.round(points[:, :2].mean(axis=0))
            points = points - offset

        cfg = self.fit_capacity(points)
        cloud = PointCloud.from_numpy(points, cfg.capacity.max_points)
        processed, people, res = self.analyze_device(cloud, cfg)
        # Exactness guard: if clustering overflowed a static capacity
        # (column cap or the compacted buffer), grow and re-run — keeps
        # DBSCAN parity on adversarial scenes at the cost of a recompile.
        while int(processed.cluster_overflow) > 0:
            grown = self._grown_cluster_cfg(cfg)
            if grown is None:
                raise RuntimeError(self._OVERFLOW_MSG.format(
                    n=int(processed.cluster_overflow)))
            cfg = grown
            processed, people, res = self.analyze_device(cloud, cfg)
        # People-capacity guard: cluster ids past max_people are dropped
        # from the segment sums (people.overflow counts them) — a dense
        # venue that beats fit_capacity's n/8 heuristic would otherwise
        # silently undercount total_people. Grow to the next power of two
        # covering every cluster and re-run (one recompile, exact result;
        # the reference never drops a cluster,
        # utils/data_processing.py:251-280).
        while int(people.overflow) > 0:
            need = cfg.capacity.max_people + int(people.overflow)
            cfg = cfg.with_capacity(
                max_people=1 << max(1, (need - 1).bit_length()))
            processed, people, res = self.analyze_device(cloud, cfg)
        # Bucketed radius-count guard: a coarse bucket past
        # density_bucket_cap drops people from the density grid
        # (ops/bucket_density.py counts them); double the cap and re-run
        # — terminates because cap >= max_people holds everyone.
        while int(res.density.radius_overflow) > 0:
            cfg = cfg.with_capacity(density_bucket_cap=min(
                cfg.capacity.max_people,
                cfg.capacity.density_bucket_cap * 2))
            processed, people, res = self.analyze_device(cloud, cfg)
        density_results = res.density.to_host_dict()
        flow_results = res.flow.to_host_dict()
        if offset.any():
            ox, oy = float(offset[0]), float(offset[1])
            density_results["origin"] = (
                density_results["origin"][0] + ox,
                density_results["origin"][1] + oy)
            for h in density_results["hotspots"]:
                h["x"] += ox
                h["y"] += oy
            for b in flow_results["bottlenecks"]:
                b["x"] += ox
                b["y"] += oy
            flow_results["flow_vectors"]["positions"] = (
                flow_results["flow_vectors"]["positions"]
                + np.array([ox, oy]))
        recommendations = generate_recommendations(
            density_results, flow_results, self.config.recommend)
        return {
            "processed": processed,
            "people": people,
            "coordinate_offset": offset,
            "density": density_results,
            "flow": flow_results,
            "recommendations": recommendations,
        }

    def analyze_sequence(self, frames, dt: float = 1.0) -> Dict:
        """Multi-frame analysis: density from the last frame, flow
        *measured* by nearest-centroid tracking over EVERY consecutive
        frame pair (models/temporal.py) instead of the reference's
        simulated field — the real implementation crowd_flow_model.py:19-26
        defers.

        Cost discipline: the final frame gets the one full analysis; every
        earlier frame runs only the tracking-only device program
        (``people_of_cloud`` — preprocess + clustering, no density/flow
        stages), so a new frame in a stream costs about one extraction
        plus O(K^2) matching, never a second full pipeline run.
        """
        from lidar_crowd.models.temporal import (
            temporal_flow_multi)

        if len(frames) < 2:
            return self.analyze(frames[0])
        out = self.analyze(frames[-1])
        processed = out["processed"]
        offset = out["coordinate_offset"]

        # track only person-like clusters: ground-hugging pseudo-clusters
        # (terrain speckle) re-randomise every frame and poison NN
        # matching with spurious velocities
        min_h = self.config.flow.track_min_height
        people_frames = []
        # one capacity config for the whole sequence => one compile of
        # the tracking program (sized to the largest frame)
        cfg = self.fit_capacity(
            np.asarray(frames[int(np.argmax([len(f) for f in frames]))],
                       dtype=np.float64)[:, :3] - offset)
        for f in frames[:-1]:
            pts = np.asarray(f, dtype=np.float64)[:, :3] - offset
            cloud = PointCloud.from_numpy(pts, cfg.capacity.max_points)
            proc, ppl = people_of_cloud(cloud, cfg)
            # same exactness guards as analyze(): grow capacities on
            # overflow instead of silently dropping clusters
            while int(proc.cluster_overflow) > 0:
                grown = self._grown_cluster_cfg(cfg)
                if grown is None:
                    raise RuntimeError(self._OVERFLOW_MSG.format(
                        n=int(proc.cluster_overflow)))
                cfg = grown
                proc, ppl = people_of_cloud(cloud, cfg)
            while int(ppl.overflow) > 0:
                need = cfg.capacity.max_people + int(ppl.overflow)
                cfg = cfg.with_capacity(
                    max_people=1 << max(1, (need - 1).bit_length()))
                proc, ppl = people_of_cloud(cloud, cfg)
            people_frames.append(ppl.person_like(min_h, proc.mins[2]))

        # the final frame's people come from the full analysis above, but
        # its capacity config may differ (analyze() fits and grows its
        # own); re-extract under cfg unless the people capacity already
        # matches, so the stacked pytree has uniform shapes
        if (out["people"].positions.shape[0]
                == cfg.capacity.max_people):
            people_frames.append(
                out["people"].person_like(min_h, processed.mins[2]))
        else:
            pts = np.asarray(frames[-1], np.float64)[:, :3] - offset
            cloud = PointCloud.from_numpy(pts, cfg.capacity.max_points)
            proc, ppl = people_of_cloud(cloud, cfg)
            people_frames.append(ppl.person_like(min_h, proc.mins[2]))

        seq = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *people_frames)
        res = temporal_flow_multi(seq, jnp.asarray(dt, jnp.float32),
                                  processed.mins[:2], processed.maxs[:2],
                                  cfg)
        flow_results = res.to_host_dict()
        if np.asarray(offset).any():
            ox, oy = float(offset[0]), float(offset[1])
            for b in flow_results["bottlenecks"]:
                b["x"] += ox
                b["y"] += oy
            flow_results["flow_vectors"]["positions"] = (
                flow_results["flow_vectors"]["positions"]
                + np.array([ox, oy]))
        out["flow"] = flow_results
        out["recommendations"] = generate_recommendations(
            out["density"], flow_results, self.config.recommend)
        return out
