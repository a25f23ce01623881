#!/usr/bin/env python
"""Fine-grained per-substage profile at venue scale.

Times each component of the full pipeline independently on device:
stats/percentile/plane (preprocess sans clustering), column-grid
clustering, people extraction (segment means), density radius-count
and flow. Prints one JSON document.

Usage: python benchmarks/profile_10m.py [--points 10000000]
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=10_000_000)
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lidar_crowd import preprocess as pp
    from lidar_crowd.models import (
        density as dm, flow as fm)
    from lidar_crowd.ops import clustering
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.types import PointCloud
    from lidar_crowd.utils.profiling import (
        device_timer)

    n = args.points
    pts = scaled_venue(n)
    pipe = Pipeline()
    cfg = pipe.fit_capacity(pts)
    cap = cfg.capacity
    clouds = [PointCloud.from_numpy(pts + i * 1e-4, cap.max_points)
              for i in range(args.iters + 1)]

    out = {"points": n, "device": str(jax.devices()[0]),
           "capacities": {
               "max_points": cap.max_points,
               "max_people": cap.max_people,
               "grid": (cap.grid_cells_x, cap.grid_cells_y),
               "cluster_cells": (cap.cluster_cells_x, cap.cluster_cells_y),
               "cluster_column_cap": cap.cluster_column_cap,
               "cluster_capacity": cap.cluster_capacity},
           "stages_ms": {}}

    def rec(name, fn, argfn):
        f = jax.jit(fn)
        dt = device_timer(f, argfn, iters=args.iters)
        out["stages_ms"][name] = round(dt * 1000, 2)
        return f(*argfn(0))

    # --- preprocess sub-pieces -------------------------------------------
    pc = cfg.preprocess

    def stats_only(cloud):
        m = pp._masked_mean(cloud.points, cloud.mask)
        s = pp._masked_std(cloud.points, cloud.mask)
        return m, s
    rec("pre_stats", stats_only, lambda i: (clouds[i % len(clouds)],))

    def percentile_only(cloud):
        return pp.masked_percentile(cloud.points[:, 2], cloud.mask,
                                    pc.ground_percentile)
    rec("pre_percentile_sort", percentile_only,
        lambda i: (clouds[i % len(clouds)],))

    def plane_only(cloud):
        z = cloud.points[:, 2]
        thr = pp.masked_percentile(z, cloud.mask, pc.ground_percentile)
        ground = cloud.mask & (z <= thr)
        return pp.fit_ground_plane(cloud.points, ground, cloud.mask)
    rec("pre_percentile_plus_plane", plane_only,
        lambda i: (clouds[i % len(clouds)],))

    # --- clustering alone ------------------------------------------------
    def cluster_only(cloud):
        labels, n_clusters, overflow = clustering.dbscan_labels(
            cloud.points, cloud.mask, pc.dbscan_eps,
            pc.dbscan_min_samples, ncx=cap.cluster_cells_x,
            ncy=cap.cluster_cells_y, column_cap=cap.cluster_column_cap,
            max_iters=cap.max_cc_iters)
        return labels, n_clusters
    labels_r = rec("clustering", cluster_only,
                   lambda i: (clouds[i % len(clouds)],))
    out["n_clusters"] = int(labels_r[1])

    # --- full preprocess + people extraction -----------------------------
    pre = jax.jit(functools.partial(pp.preprocess, config=cfg))
    processed = pre(clouds[0])
    processed = jax.block_until_ready(processed)

    def people_only(proc):
        return dm.extract_people(proc, cfg)
    people = rec("extract_people", people_only, lambda i: (processed,))
    out["n_people"] = int(np.asarray(people.count))

    dens = functools.partial(dm.analyze_density, config=cfg)
    rec("density", dens, lambda i: (processed, people))

    u = jnp.asarray(fm.bottleneck_uniforms(), jnp.float32)
    flw = functools.partial(fm.analyze_flow, config=cfg)
    rec("flow", flw, lambda i: (processed, people, u))

    f_full = functools.partial(pipe.analyze_device, config=cfg)
    dt = device_timer(f_full, lambda i: (clouds[i % len(clouds)],),
                      iters=args.iters)
    out["stages_ms"]["full_pipeline"] = round(dt * 1000, 2)
    out["points_per_sec"] = round(n / dt)

    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
