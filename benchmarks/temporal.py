#!/usr/bin/env python
"""Temporal flow benchmark (BASELINE.md config 3): multi-frame sequences,
tracked flow-vector prediction — points/s and flow cosine accuracy vs the
known generator motion.

Usage: python benchmarks/temporal.py [--points 100000] [--frames 4]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=50_000)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dt", type=float, default=0.5)
    args = ap.parse_args()

    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import (
        venue_sequence)

    extent = max(15.0, (args.points / 10000.0) ** 0.5 * 15.0)
    n_people = max(10, int(50 * (extent / 15.0) ** 2))
    frames = venue_sequence(n_frames=args.frames, dt=args.dt,
                            n_points=args.points, n_people=n_people,
                            extent=extent, speed=1.0)
    pipe = Pipeline()
    # warmup run absorbs the jit compiles; report steady-state
    pipe.analyze_sequence(frames, dt=args.dt)
    t0 = time.time()
    out = pipe.analyze_sequence(frames, dt=args.dt)
    wall = time.time() - t0

    f = out["flow"]
    vec = np.asarray(f["flow_vectors"]["vectors"])
    pos = np.asarray(f["flow_vectors"]["positions"])
    # ground-truth direction at each node: toward the exit at (extent, 0)
    gt = np.stack([extent - pos[:, 0], -pos[:, 1]], 1)
    gt /= np.maximum(np.linalg.norm(gt, axis=1, keepdims=True), 1e-9)
    vn = np.linalg.norm(vec, axis=1)
    ok = vn > 0.05
    cos = float(np.mean(np.sum(vec[ok] / vn[ok, None] * gt[ok], axis=1))
                ) if ok.any() else float("nan")

    print(json.dumps({
        "metric": "temporal_flow",
        "frames": args.frames, "points_per_frame": args.points,
        "wall_s": round(wall, 2),
        "points_per_sec": round(args.points * args.frames / wall),
        "measured_avg_speed": round(float(f["avg_speed"]), 3),
        "true_speed": 1.0,
        "flow_cosine_vs_truth": round(cos, 3),
        "dominant_direction": f["dominant_direction"],
    }))


if __name__ == "__main__":
    main()
