#!/usr/bin/env python
"""Per-stage benchmark harness (BASELINE.md configs 1-4).

Measures each pipeline stage (and the CPU oracle equivalents) at chosen
sizes, printing a JSON document. Timing via utils/profiling.device_timer
(distinct inputs, block_until_ready).

Usage: python benchmarks/stages.py [--points 100000] [--iters 3]
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--skip-oracle", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lidar_crowd.models import (
        density as dm, flow as fm)
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.types import PointCloud
    from lidar_crowd.utils.profiling import (
        device_timer)
    from lidar_crowd import preprocess as pp

    n = args.points
    pts = scaled_venue(n)
    pipe = Pipeline()
    cfg = pipe.fit_capacity(pts)
    cap = cfg.capacity.max_points
    clouds = [PointCloud.from_numpy(pts + i * 1e-4, cap)
              for i in range(args.iters + 1)]

    results = {"points": n, "device": str(jax.devices()[0]),
               "capacities": {
                   "max_points": cfg.capacity.max_points,
                   "max_people": cfg.capacity.max_people,
                   "grid": cfg.capacity.grid_cells_x,
                   "cluster_cells": cfg.capacity.cluster_cells_x},
               "stages_ms": {}}

    # full pipeline
    f_full = functools.partial(pipe.analyze_device, config=cfg)
    dt = device_timer(f_full, lambda i: (clouds[i % len(clouds)],),
                      iters=args.iters)
    results["stages_ms"]["full_pipeline"] = round(dt * 1000, 2)
    results["points_per_sec"] = round(n / dt)

    # preprocess (includes clustering)
    pre = jax.jit(functools.partial(pp.preprocess, config=cfg))
    dt = device_timer(pre, lambda i: (clouds[i % len(clouds)],),
                      iters=args.iters)
    results["stages_ms"]["preprocess_with_clustering"] = round(dt * 1000,
                                                              2)

    processed = pre(clouds[0])
    ppl_fn = jax.jit(functools.partial(dm.extract_people, config=cfg))
    dt = device_timer(ppl_fn, lambda i: (processed,),
                      iters=args.iters)
    results["stages_ms"]["extract_people"] = round(dt * 1000, 2)
    people = ppl_fn(processed)

    dens = jax.jit(functools.partial(dm.analyze_density, config=cfg))
    dt = device_timer(dens, lambda i: (processed, people),
                      iters=args.iters)
    results["stages_ms"]["density"] = round(dt * 1000, 2)

    u = jnp.asarray(fm.bottleneck_uniforms(), jnp.float32)
    flw = jax.jit(functools.partial(fm.analyze_flow, config=cfg))
    dt = device_timer(flw, lambda i: (processed, people, u),
                      iters=args.iters)
    results["stages_ms"]["flow"] = round(dt * 1000, 2)

    if not args.skip_oracle:
        from lidar_crowd.oracle import (
            reference as ref)
        t0 = time.time()
        oracle = ref.analyze(pts, variant="monolith")
        results["cpu_oracle_ms"] = round((time.time() - t0) * 1000, 1)
        results["cpu_points_per_sec"] = round(
            n / ((time.time() - t0) or 1))
        results["speedup_vs_cpu"] = round(
            results["points_per_sec"] / results["cpu_points_per_sec"], 1)
        # correctness alongside speed
        out = pipe.analyze(pts)
        og = oracle["density"]["density_grid"]
        g = out["density"]["density_grid"]
        results["density_mae_vs_oracle"] = (
            float(np.abs(g - og).mean()) if g.shape == og.shape
            else None)
        results["people_parity"] = bool(
            out["density"]["total_people"]
            == oracle["density"]["total_people"])

    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
