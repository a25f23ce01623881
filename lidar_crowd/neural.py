"""Neural serving path: CrowdNet inference as a product capability.

The reference only *documents* an ML ambition ("AI-based flow analysis",
windows_design.md:60-66); here the flagship CrowdNet (models/crowdnet.py)
is reachable from the product surface: ``lidar-crowd train`` distils the
analytic pipeline into a checkpoint, and ``lidar-crowd analyze --neural
<ckpt>`` / ``NeuralPipeline(ckpt)`` serves density + flow + congestion
from raw points in ONE forward pass — no clustering, no grid
statistics at inference time.

Output contract: the same reference-shaped density/flow dicts the
analytic ``Pipeline.analyze`` emits (types.py to_host_dict semantics), so
reports, stores and the recommendation engine are shared unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lidar_crowd.config import (
    MONOLITH_CONFIG, PipelineConfig)
from lidar_crowd.models.crowdnet import (
    BatchedCrowdNet)
from lidar_crowd.models.train import (
    load_params_npz, make_model)
from lidar_crowd.utils.recommendations import (
    generate_recommendations)

# Packaged tiny checkpoint (distilled on synthetic venues; see
# tools/train_release_checkpoint.py for the exact recipe + metrics).
DEFAULT_CHECKPOINT = "crowdnet_tiny.npz"


def default_checkpoint_path() -> str:
    import os
    return os.path.join(os.path.dirname(__file__), "assets",
                        DEFAULT_CHECKPOINT)


def _compass(vx: float, vy: float) -> str:
    """8-way compass of a mean vector (crowd_flow_model.py:65-74)."""
    angle = float(np.arctan2(vy, vx) * 180.0 / np.pi)
    directions = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]
    return directions[int((angle + 22.5) % 360 / 45)]


class NeuralPipeline:
    """Host-facing CrowdNet inference with reference-shaped outputs.

    Parameters
    ----------
    checkpoint: path to a ``save_params_npz`` artifact (default: the
        packaged tiny checkpoint).
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 config: PipelineConfig = MONOLITH_CONFIG):
        self.config = config
        path = checkpoint or default_checkpoint_path()
        self.params, self.train_config = load_params_npz(path)
        # Legacy-checkpoint migration: artifacts trained before the
        # dedicated count head (crowdnet.py count_head) lack its params
        # and would crash at apply time. Graft zero params (the two count
        # convs mirror the density-head shapes) and fall back to the
        # density-integral count in analyze() — degraded but serving.
        self._legacy_count = False
        net = self.params.get("VmapCrowdNet_0", self.params)
        if "density_head" in net and "count_head" not in net:
            import logging
            logging.getLogger("lidar_crowd.neural").warning(
                "checkpoint %s predates the count head; people counts "
                "fall back to the density integral — retrain with "
                "`lidar-crowd train` for calibrated counts", path)
            net["count_head_hidden"] = jax.tree_util.tree_map(
                np.zeros_like, net["density_head_hidden"])
            net["count_head"] = jax.tree_util.tree_map(
                np.zeros_like, net["density_head"])
            self._legacy_count = True
        self.model: BatchedCrowdNet = make_model(self.train_config)
        self._validate_params(path)
        self._apply = jax.jit(self.model.apply)
        self._rng = np.random.RandomState(0)

    def _validate_params(self, path: str) -> None:
        """Check the (possibly migrated) checkpoint tree against the
        model's expected shapes so a format mismatch fails HERE with a
        named error, not at apply time with an opaque flax one
        (ADVICE r4: a differently-nested legacy tree skips migration)."""
        n_cap = self.train_config.n_points
        expected = jax.eval_shape(
            lambda: self.model.init(
                jax.random.PRNGKey(0),
                jnp.zeros((1, n_cap, 3), jnp.float32),
                jnp.ones((1, n_cap), bool),
                jnp.zeros((1, 2), jnp.float32),
                jnp.ones((1,), jnp.float32)))["params"]
        exp_paths = {jax.tree_util.keystr(k): v.shape for k, v in
                     jax.tree_util.tree_leaves_with_path(expected)}
        got_paths = {jax.tree_util.keystr(k): np.shape(v) for k, v in
                     jax.tree_util.tree_leaves_with_path(self.params)}
        if exp_paths != got_paths:
            missing = sorted(set(exp_paths) - set(got_paths))[:5]
            extra = sorted(set(got_paths) - set(exp_paths))[:5]
            wrong = sorted(
                k for k in set(exp_paths) & set(got_paths)
                if exp_paths[k] != got_paths[k])[:5]
            raise ValueError(
                f"checkpoint {path!r} does not match the CrowdNet "
                f"parameter tree (format mismatch): "
                f"missing={missing} unexpected={extra} "
                f"wrong_shape={wrong}. Retrain with `lidar-crowd train` "
                f"or pass a compatible checkpoint.")

    # -- device step --------------------------------------------------------

    def forward(self, points: np.ndarray, venue_min: np.ndarray,
                venue_size: float) -> Dict[str, np.ndarray]:
        """One batched-of-1 forward pass; returns host arrays
        {density (G,G) people/m^2, flow (G,G,2) m/s, congestion (G,G)}."""
        n_cap = self.train_config.n_points
        pts = np.asarray(points, np.float32)
        n = len(pts)
        if n > n_cap:
            # reference downsampler semantics (data_processing.py:231-249):
            # uniform random subset without replacement
            keep = self._rng.choice(n, n_cap, replace=False)
            pts = pts[keep]
            n = n_cap
        pad = n_cap - n
        mask = np.zeros(n_cap, bool)
        mask[:n] = True
        if pad:
            pts = np.concatenate(
                [pts, np.zeros((pad, 3), np.float32)], axis=0)
        out = self._apply(
            {"params": self.params},
            jnp.asarray(pts)[None], jnp.asarray(mask)[None],
            jnp.asarray(venue_min, jnp.float32)[None],
            jnp.asarray(venue_size, jnp.float32)[None])
        return {k: np.asarray(v[0]) for k, v in out.items()}

    # -- host-facing analysis ------------------------------------------------

    def analyze(self, points: np.ndarray) -> Dict:
        """NumPy points in, reference-shaped result dicts out (the same
        contract as Pipeline.analyze, minus the per-point processed
        tensors that the neural path never materialises)."""
        points = np.asarray(points, dtype=np.float64)[:, :3]
        offset = np.zeros(3)
        if np.abs(points[:, :2]).max() > 4096.0:  # Pipeline.RECENTER_THRESHOLD
            offset[:2] = np.round(points[:, :2].mean(axis=0))
            points = points - offset

        vmin = points[:, :2].min(axis=0)
        vmax = points[:, :2].max(axis=0)
        vsize = float(max(vmax[0] - vmin[0], vmax[1] - vmin[1])) + 1e-6
        out = self.forward(points, vmin.astype(np.float32), vsize)

        g = self.train_config.grid
        cell = vsize / g
        cell_area = cell ** 2
        density = out["density"]
        flow = out["flow"]
        congestion = out["congestion"]

        dc = self.config.density
        # count comes from the dedicated count head (crowdnet.py): the
        # MAE-trained density map is mass-losing by construction
        # (conditional-median), so its integral undercounts. Legacy
        # checkpoints (no count head) use that integral anyway — the
        # honest pre-count-head behaviour.
        if self._legacy_count:
            total_people = int(round(float(density.sum()) * cell_area))
        else:
            total_people = int(round(float(out["count"])))
        venue_area = max(1.0, float((vmax[0] - vmin[0])
                                    * (vmax[1] - vmin[1])))
        avg_density = total_people / venue_area  # monolith semantics
        max_density = float(density.max())

        # hotspot rule shared with the analytic path
        # (crowd_density_model.py:67-82): cells >= max(0.5, 1.5*avg),
        # top-5 by density, x-major tie order
        threshold = max(dc.hotspot_min_threshold,
                        dc.hotspot_avg_multiplier * avg_density)
        flat = density.reshape(-1)
        idx = np.argsort(-flat, kind="stable")[:64]
        hotspots = []
        for i in idx:
            if flat[i] < threshold or len(hotspots) >= dc.max_hotspots:
                break
            ci, cj = divmod(int(i), g)
            hotspots.append({
                "x": float(vmin[0] + (ci + 0.5) * cell + offset[0]),
                "y": float(vmin[1] + (cj + 0.5) * cell + offset[1]),
                "density": float(flat[i])})

        density_results = {
            "total_people": total_people,
            "avg_density": float(avg_density),
            "max_density": max_density,
            "density_map": density,
            "density_grid": density.T,
            "origin": (float(vmin[0] + offset[0]),
                       float(vmin[1] + offset[1])),
            "hotspots": hotspots,
        }

        mags = np.sqrt((flow ** 2).sum(-1))
        mean_vec = flow.mean(axis=(0, 1))
        ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        px = vmin[0] + (ii + 0.5) * cell + offset[0]
        py = vmin[1] + (jj + 0.5) * cell + offset[1]

        flow_results = {
            "avg_speed": float(mags.mean()),
            "dominant_direction": _compass(*mean_vec),
            "bottlenecks": self._bottlenecks(mags, px, py, cell),
            "flow_vectors": {
                "positions": np.stack([px.reshape(-1), py.reshape(-1)],
                                      axis=1),
                "vectors": flow.reshape(-1, 2),
                "magnitudes": mags.reshape(-1),
            },
            "congestion_map": congestion,
        }

        recommendations = generate_recommendations(
            density_results, flow_results, self.config.recommend)
        return {
            "density": density_results,
            "flow": flow_results,
            "congestion": {"map": congestion,
                           "max": float(congestion.max())},
            "coordinate_offset": offset,
            "recommendations": recommendations,
        }

    def _bottlenecks(self, mags: np.ndarray, px, py, cell: float):
        """Monolith bottleneck rule (app_simplified.py:430-449) adapted to
        the BEV lattice: slow nodes (<0.3 m/s) within a 3 m box of a
        fast (>0.5 m/s) node; severity = int(10*(box_max-mag)/box_max)."""
        fc = self.config.flow
        g = mags.shape[0]
        span = max(1, int(np.ceil(fc.mono_box_halfwidth / cell)) - 1)
        box_max = np.zeros_like(mags)
        for dx in range(-span, span + 1):
            for dy in range(-span, span + 1):
                sl = np.zeros_like(mags)
                xs0, xs1 = max(0, -dx), min(g, g - dx)
                ys0, ys1 = max(0, -dy), min(g, g - dy)
                sl[xs0:xs1, ys0:ys1] = mags[xs0 + dx:xs1 + dx,
                                            ys0 + dy:ys1 + dy]
                box_max = np.maximum(box_max, sl)
        sev = np.floor(10.0 * (box_max - mags)
                       / np.maximum(box_max, 1e-12)).astype(int)
        sev = np.minimum(10, sev)
        ok = ((mags < fc.mono_slow_speed) & (box_max > fc.mono_fast_speed)
              & (sev >= fc.mono_min_severity))
        flat_sev = np.where(ok.T.reshape(-1), sev.T.reshape(-1), -1)
        order = np.argsort(-flat_sev, kind="stable")[:fc.max_bottlenecks]
        fx = px.T.reshape(-1)
        fy = py.T.reshape(-1)
        return [{"x": float(fx[i]), "y": float(fy[i]),
                 "severity": int(flat_sev[i])}
                for i in order if flat_sev[i] >= 0]
