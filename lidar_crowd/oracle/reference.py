"""CPU NumPy oracle: a faithful reimplementation of the reference
algorithms' observable behaviour, used as (a) the golden source for parity
tests and (b) the measured performance baseline (BASELINE.md: the reference
publishes no numbers, so the baseline is this CPU path measured directly).

Semantics follow, per function, the cited lines of /root/reference. This is
an independent implementation — structure and code are our own; behaviour
(thresholds, RNG draw order, iteration order, tie-breaking) matches the
reference so results are comparable bit-for-bit where float precision
allows. It intentionally preserves the reference's *algorithmic* shape on
hot paths (per-cell KD-tree queries, per-node Python loops) because that is
the baseline the device path is measured against.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from sklearn.cluster import DBSCAN
from sklearn.neighbors import KDTree
from sklearn.preprocessing import StandardScaler


# ---------------------------------------------------------------------------
# Preprocessing (utils/data_processing.py:127-229; app_simplified.py:76-137)
# ---------------------------------------------------------------------------

def preprocess(points: np.ndarray, variant: str = "monolith") -> Dict:
    """Outlier rejection -> ground split -> DBSCAN person clustering.

    variant="monolith": DBSCAN(eps=0.3, min_samples=5) on raw non-ground
    points (app_simplified.py:103-110).
    variant="modular": StandardScaler + adaptive eps in [0.2, 0.5]
    (utils/data_processing.py:185-198) and a least-squares ground plane.
    """
    z = points[:, 2]
    zspan = z.max() - z.min() + 1e-10
    nh = (z - z.min()) / zspan
    colors = np.stack([nh, 0.5 * (1 - nh), np.full_like(nh, 0.5)], axis=1)

    mean = points.mean(axis=0)
    std = points.std(axis=0)
    inlier_mask = np.all(np.abs(points - mean) < 3 * std, axis=1)
    pts = points[inlier_mask]
    colors = colors[inlier_mask]

    normals = np.zeros_like(pts)
    normals[:, 2] = 1.0

    z_thresh = np.percentile(pts[:, 2], 30)
    ground = pts[:, 2] <= z_thresh
    non_ground = ~ground

    # Ground plane (modular only: utils/data_processing.py:169-183)
    if np.sum(ground) > 10:
        gp = pts[ground]
        A = np.column_stack([gp[:, 0], gp[:, 1], np.ones(len(gp))])
        try:
            sol, *_ = np.linalg.lstsq(A, gp[:, 2], rcond=None)
            plane = np.array([sol[0], sol[1], -1.0, sol[2]])
        except np.linalg.LinAlgError:
            plane = np.array([0.0, 0.0, 1.0, -gp[:, 2].mean()])
    else:
        plane = np.array([0.0, 0.0, 1.0, -pts[:, 2].min()])

    ng_pts = pts[non_ground]
    if len(ng_pts) > 10:
        if variant == "modular":
            scaled = StandardScaler().fit_transform(ng_pts)
            eps = float(np.clip(np.mean(np.std(scaled, axis=0)) * 0.5,
                                0.2, 0.5))
            labels = DBSCAN(eps=eps, min_samples=5).fit(scaled).labels_
        else:
            labels = DBSCAN(eps=0.3, min_samples=5).fit(ng_pts).labels_
    else:
        labels = np.zeros(len(ng_pts), dtype=int)

    full = np.full(len(pts), -1, dtype=int)
    full[non_ground] = labels

    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    return {
        "points": pts,
        "colors": colors,
        "normals": normals,
        "clusters": full,
        "ground_mask": ground,
        "ground_plane": plane,
        "dimensions": {
            "x_range": (mins[0], maxs[0]),
            "y_range": (mins[1], maxs[1]),
            "z_range": (mins[2], maxs[2]),
            "width": maxs[0] - mins[0],
            "length": maxs[1] - mins[1],
            "height": maxs[2] - mins[2],
        },
    }


def people_positions(processed: Dict) -> np.ndarray:
    """Per-cluster xy centroids (utils/data_processing.py:251-280)."""
    pts = processed["points"]
    labels = processed["clusters"]
    out = []
    for cid in np.unique(labels[labels >= 0]):
        out.append(pts[labels == cid].mean(axis=0)[:2])
    return np.array(out) if out else np.zeros((0, 2))


# ---------------------------------------------------------------------------
# Density (models/crowd_density_model.py; app_simplified.py:234-316)
# ---------------------------------------------------------------------------

def density_analysis(processed: Dict, mode: str = "radius",
                     grid_size: float = 1.0) -> Dict:
    pos = people_positions(processed)
    dims = processed["dimensions"]
    n_people = len(pos)

    if mode == "radius":
        # Monolith path: avg density = people/bbox area; per-cell KD-tree
        # radius-2 count / 4 m^2 (app_simplified.py:244-281).
        area = dims["width"] * dims["length"]
        avg_density = n_people / max(1, area)
        if n_people == 0:
            return {"total_people": 0, "avg_density": avg_density,
                    "max_density": 0.0, "density_grid": np.zeros((1, 1)),
                    "hotspots": []}
        x0, x1 = dims["x_range"]
        y0, y1 = dims["y_range"]
        xg = np.arange(x0, x1 + grid_size, grid_size)
        yg = np.arange(y0, y1 + grid_size, grid_size)
        grid = np.zeros((len(yg) - 1, len(xg) - 1))
        tree = KDTree(pos)
        for i in range(len(xg) - 1):
            for j in range(len(yg) - 1):
                c = np.array([(xg[i] + xg[i + 1]) / 2,
                              (yg[j] + yg[j + 1]) / 2])
                grid[j, i] = len(tree.query_radius([c], r=2.0)[0]) / 4.0
        max_density = grid.max()
        thresh = max(0.5, avg_density * 1.5)
        hotspots = []
        for j in range(grid.shape[0]):
            for i in range(grid.shape[1]):
                if grid[j, i] >= thresh:
                    hotspots.append({
                        "x": (xg[i] + xg[i + 1]) / 2,
                        "y": (yg[j] + yg[j + 1]) / 2,
                        "density": grid[j, i],
                    })
        hotspots = sorted(hotspots, key=lambda h: h["density"],
                          reverse=True)[:5]
        return {"total_people": n_people, "avg_density": avg_density,
                "max_density": max_density, "density_grid": grid,
                "hotspots": hotspots}

    # Histogram path (utils/data_processing.py:282-328 +
    # crowd_density_model.py:48-96).
    if n_people == 0:
        return {"total_people": 0, "avg_density": 0.0, "max_density": 0.0,
                "density_map": np.zeros((1, 1)), "hotspots": []}
    x0, x1 = dims["x_range"]
    y0, y1 = dims["y_range"]
    margin = grid_size * 2
    xe = np.arange(x0 - margin, x1 + margin + grid_size, grid_size)
    ye = np.arange(y0 - margin, y1 + margin + grid_size, grid_size)
    hist, xe, ye = np.histogram2d(pos[:, 0], pos[:, 1], bins=[xe, ye])
    grid = hist / (grid_size * grid_size)
    gx = (xe[:-1] + xe[1:]) / 2
    gy = (ye[:-1] + ye[1:]) / 2
    flat = grid.flatten()
    fx = np.repeat(gx, len(gy))
    fy = np.tile(gy, len(gx))
    max_density = flat.max()
    avg_density = flat[flat > 0].mean() if np.any(flat > 0) else 0.0
    thresh = max(0.5, avg_density * 1.5)
    idx = np.where(flat >= thresh)[0]
    hotspots = sorted(
        [{"x": fx[i], "y": fy[i], "density": flat[i]} for i in idx],
        key=lambda h: h["density"], reverse=True)[:5]
    return {"total_people": n_people, "avg_density": avg_density,
            "max_density": max_density, "density_map": grid,
            "hotspots": hotspots}


# ---------------------------------------------------------------------------
# Flow (models/crowd_flow_model.py; app_simplified.py:318-464)
# ---------------------------------------------------------------------------

def flow_analysis(processed: Dict, variant: str = "monolith") -> Dict:
    pos = people_positions(processed)
    if len(pos) == 0:
        return {"avg_speed": 0.0, "dominant_direction": "N/A",
                "bottlenecks": [],
                "flow_vectors": {"positions": np.zeros((0, 2)),
                                 "vectors": np.zeros((0, 2)),
                                 "magnitudes": np.zeros(0)}}
    dims = processed["dimensions"]
    x0, x1 = dims["x_range"]
    y0, y1 = dims["y_range"]
    g = 1.0
    xg = np.arange(x0, x1 + g, g)
    yg = np.arange(y0, y1 + g, g)
    X, Y = np.meshgrid(xg, yg)
    nodes = np.vstack([X.ravel(), Y.ravel()]).T

    np.random.seed(42)
    exit_x, exit_y = x1, (y0 + y1) / 2
    complexity = 0.3 if variant == "monolith" else 2.0

    dx = exit_x - nodes[:, 0]
    dy = exit_y - nodes[:, 1]
    dist = np.sqrt(dx * dx + dy * dy)
    nz = dist > 0
    ux = np.where(nz, dx / np.where(nz, dist, 1.0), 0.0)
    uy = np.where(nz, dy / np.where(nz, dist, 1.0), 0.0)
    ang = (np.sin(nodes[:, 0] * complexity)
           * np.cos(nodes[:, 1] * complexity) * 0.5)
    ca, sa = np.cos(ang), np.sin(ang)
    vectors = np.stack([ux * ca - uy * sa, ux * sa + uy * ca], axis=1)
    vectors[~nz] = 0.0

    for _ in range(3):
        bx = np.random.uniform(x0 + 1, x1 - 1)
        by = np.random.uniform(y0 + 1, y1 - 1)
        d = np.sqrt((nodes[:, 0] - bx) ** 2 + (nodes[:, 1] - by) ** 2)
        damp = np.where(d < 3.0, d / 3.0, 1.0)
        vectors *= damp[:, None]

    mags = np.linalg.norm(vectors, axis=1)
    if variant == "monolith":
        # scale so max == 1.3 (app_simplified.py:409)
        scale = 1.3 / mags.max() if mags.max() > 0 else 1.0
        vectors *= scale
        mags = np.linalg.norm(vectors, axis=1)
    else:
        # modular: scale by (1.5-0.2)/max, then clip magnitudes
        # (crowd_flow_model.py:171-175)
        scale = (1.5 - 0.2) / mags.max() if mags.max() > 0 else 1.0
        vectors *= scale
        mags = np.clip(np.linalg.norm(vectors, axis=1), 0.2, 1.5)

    avg_speed = mags.mean()
    av = vectors.mean(axis=0)
    angle = np.arctan2(av[1], av[0]) * 180 / np.pi
    directions = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]
    dominant = directions[int((angle + 22.5) % 360 / 45)]

    if variant == "monolith":
        bottlenecks = _bottlenecks_monolith(nodes, mags)
    else:
        bottlenecks = _bottlenecks_modular(nodes, vectors, mags)

    return {"avg_speed": avg_speed, "dominant_direction": dominant,
            "bottlenecks": bottlenecks,
            "flow_vectors": {"positions": nodes, "vectors": vectors,
                             "magnitudes": mags}}


def _bottlenecks_monolith(nodes: np.ndarray, mags: np.ndarray):
    """app_simplified.py:430-449: speed<0.3, 3x3 m box neighbourhood,
    severity = int(10*(max_nbr-mag)/max_nbr) if max_nbr>0.5, keep >=3."""
    out = []
    for i, (p, m) in enumerate(zip(nodes, mags)):
        if m >= 0.3:
            continue
        near = (np.abs(nodes[:, 0] - p[0]) < 3) & \
               (np.abs(nodes[:, 1] - p[1]) < 3)
        sp = mags[near]
        if len(sp) and sp.max() > 0.5:
            sev = min(10, int(10 * (sp.max() - m) / sp.max()))
            if sev >= 3:
                out.append({"x": p[0], "y": p[1], "severity": sev})
    return sorted(out, key=lambda b: b["severity"], reverse=True)[:5]


def _bottlenecks_modular(nodes: np.ndarray, vectors: np.ndarray,
                         mags: np.ndarray):
    """crowd_flow_model.py:186-279: r=3/r=5 KD-tree rings, severity =
    (speed_gradient*5 + convergence*5)/2 > 1."""
    tree = KDTree(nodes)
    out = []
    for i, (p, m) in enumerate(zip(nodes, mags)):
        if m > 0.5:
            continue
        near = tree.query_radius([p], r=3.0)[0]
        if len(near) < 5:
            continue
        far = np.setdiff1d(tree.query_radius([p], r=5.0)[0], near)
        if len(far) < 3:
            continue
        grad = mags[far].mean() - mags[near].mean()
        conv = 0.0
        for j in near:
            d = p - nodes[j]
            n = np.linalg.norm(d)
            if n > 0:
                conv += max(0.0, float(np.dot(d / n, vectors[j])))
        conv /= len(near)
        sev = (grad * 5 + conv * 5) / 2
        if sev > 1.0:
            out.append({"x": p[0], "y": p[1],
                        "severity": min(10, round(sev))})
    return sorted(out, key=lambda b: b["severity"], reverse=True)[:5]


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def analyze(points: np.ndarray, variant: str = "monolith") -> Dict:
    processed = preprocess(points, variant=variant)
    mode = "radius" if variant == "monolith" else "histogram"
    return {
        "processed": processed,
        "density": density_analysis(processed, mode=mode),
        "flow": flow_analysis(processed, variant=variant),
    }
