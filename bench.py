#!/usr/bin/env python
"""Headline benchmark: full analytics pipeline points/s on one GPU.

Protocol (BASELINE.md — the reference publishes no numbers):
  - device: the jitted pipeline (preprocess -> clustering -> density ->
    flow -> bottlenecks) on a 1M-point synthetic venue, steady state:
    the median over calls on distinct clouds, each fenced by
    ``block_until_ready``; the same on a 10M-point venue;
  - CPU baseline and correctness beside speed, when scikit-learn is
    installed: the faithful NumPy/sklearn oracle on a 100K-point venue,
    its points/s, and the device's density-grid MAE and people count
    against it (vs_baseline is null without scikit-learn; chip_smoke.py
    checks the device against the CPU either way);
  - the set-abstraction layer (FPS + ball query + shared MLP, bf16
    operands) on a 100K-point frame.

Refuses to run without a GPU. Prints the card's name and power limit,
then exactly one JSON line.
"""

import json
import subprocess
import sys
import time

import numpy as np


def pipeline_ms(pipe, pts, iters):
    """Steady-state ms of the device program on ``pts``."""
    from lidar_crowd.types import PointCloud
    from lidar_crowd.utils.profiling import device_timer
    cfg = pipe.fit_capacity(pts)
    clouds = [PointCloud.from_numpy(pts + i * 1e-4, cfg.capacity.max_points)
              for i in range(iters + 1)]
    return 1000.0 * device_timer(lambda c: pipe.analyze_device(c, cfg),
                                 lambda i: (clouds[i],), iters=iters)


def sa_layer_ms(pts_np, iters=3):
    import jax
    import jax.numpy as jnp

    from lidar_crowd.ops.grouping import (
        ball_group, group_features, sa_mlp_pool)
    from lidar_crowd.ops.sampling import farthest_point_sampling
    from lidar_crowd.utils.profiling import device_timer

    n, m, k = len(pts_np), 4096, 32
    mask = jnp.ones(n, bool)
    rng = np.random.RandomState(0)
    dims = [3, 32, 32, 64]
    w = [(jnp.asarray(rng.randn(a, b) * a ** -0.5, jnp.float32),
          jnp.zeros(b, jnp.float32)) for a, b in zip(dims[:-1], dims[1:])]

    @jax.jit
    def sa(p):
        idx = farthest_point_sampling(p, mask, m)
        cents = p[idx]
        gidx, gvalid = ball_group(cents, mask[idx], p, mask, 0.6, k)
        g = group_features(p, None, cents, gidx, gvalid)
        return sa_mlp_pool(g, gvalid, w, compute_dtype=jnp.bfloat16)

    clouds = [jnp.asarray(pts_np + i * 1e-4, jnp.float32)
              for i in range(iters + 1)]
    return 1000.0 * device_timer(sa, lambda i: (clouds[i],), iters=iters)


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU (JAX backend {jax.default_backend()!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()
    print(card, flush=True)

    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue

    n_dev, n_small, n_10m = 1_000_000, 100_000, 10_000_000
    dev = jax.devices()[0]
    detail = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices()), "nvidia_smi": card},
              "device_points": n_dev, "cpu_points": n_small}
    record = {"metric": "full_pipeline_points_per_sec_1gpu", "value": 0,
              "unit": "points/s", "vs_baseline": None, "detail": detail}

    pipe = Pipeline()
    pts_small = scaled_venue(n_small)
    ms = pipeline_ms(pipe, scaled_venue(n_dev), iters=4)
    record["value"] = round(n_dev / (ms / 1000.0))
    detail["device_step_ms"] = ms

    try:
        from lidar_crowd.oracle import reference as ref
    except ImportError as e:  # scikit-learn is an optional extra
        detail["cpu_baseline"] = f"not run: {e}"
    else:
        t0 = time.perf_counter()
        oracle = ref.analyze(pts_small, variant="monolith")["density"]
        cpu_pps = n_small / (time.perf_counter() - t0)
        detail["cpu_points_per_sec"] = round(cpu_pps)
        record["vs_baseline"] = round(record["value"] / cpu_pps, 2)
        ours = pipe.analyze(pts_small)["density"]
        detail["density_mae_vs_oracle_100k"] = float(np.abs(
            ours["density_grid"] - oracle["density_grid"]).mean())
        detail["people_parity_100k"] = (ours["total_people"]
                                        == oracle["total_people"])

    ms = pipeline_ms(pipe, scaled_venue(n_10m), iters=2)
    detail["step_ms_10m"] = ms
    detail["points_per_sec_10m"] = round(n_10m / (ms / 1000.0))

    ms = sa_layer_ms(pts_small)
    detail["sa_layer_ms"] = ms
    detail["sa_layer_points_per_sec"] = round(n_small / (ms / 1000.0))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
