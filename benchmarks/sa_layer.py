#!/usr/bin/env python
"""Single set-abstraction layer benchmark (BASELINE.md config 2):
FPS + ball-query grouping + shared-MLP pooling on an N-point frame.

Runs the layer with f32 and with bf16 matmul operands (f32 accumulate)
and reports ms per layer, points/s and roofline shares against the
device's published peaks (utils/profiling.py); max|diff| between the two
is printed beside them. Usage: python benchmarks/sa_layer.py
[--points 100000]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--radius", type=float, default=0.6)
    ap.add_argument("--channels", type=int, nargs=3,
                    default=[32, 32, 64])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lidar_crowd.ops.grouping import (
        ball_group, group_features, sa_mlp_pool)
    from lidar_crowd.ops.sampling import (
        farthest_point_sampling)
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.utils.profiling import (
        device_timer, roofline)

    n, m, k = args.points, args.samples, args.k
    pts_np = scaled_venue(n).astype(np.float32)
    rng = np.random.RandomState(0)
    w = []
    dims = [3] + list(args.channels)
    for a, b in zip(dims[:-1], dims[1:]):
        w.append((jnp.asarray(rng.randn(a, b) * 0.1, jnp.float32),
                  jnp.zeros(b, jnp.float32)))

    mask = jnp.ones(n, bool)

    def sa_layer(points, compute_dtype):
        idx = farthest_point_sampling(points, mask, m)
        cents = points[idx]
        cmask = mask[idx]
        gidx, gvalid = ball_group(cents, cmask, points, mask,
                                  args.radius, k)
        g = group_features(points, None, cents, gidx, gvalid)
        return sa_mlp_pool(g, gvalid, w, compute_dtype=compute_dtype)

    clouds = [jnp.asarray(pts_np + i * 1e-4) for i in range(args.iters + 2)]

    f32 = np.asarray(jax.jit(lambda p: sa_layer(p, jnp.float32))(
        clouds[0]))
    bf16 = np.asarray(jax.jit(lambda p: sa_layer(p, jnp.bfloat16))(
        clouds[0]))
    max_diff = float(np.abs(f32 - bf16).max())

    # flop/byte model: FPS m*n (~8/pair distance+min) + ball query m*n
    # (~8) + MLP 2*m*k*sum(cin*cout); bytes: points in, grouped tensor
    # once, pooled out
    mlp_flops = m * k * sum(2 * a * b for a, b in
                            zip(dims[:-1], dims[1:]))
    flops = m * n * 8 + m * n * 8 + mlp_flops
    bytes_accessed = (n * 3 * 4 + m * k * dims[0] * 4
                      + m * dims[-1] * 4)

    variants = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        f = jax.jit(lambda p, dt=dt: sa_layer(p, dt))
        sec = device_timer(f, lambda i: (clouds[i % len(clouds)],),
                           iters=args.iters)
        rl = roofline(flops, bytes_accessed, sec)
        variants[name] = {
            "ms_per_layer": round(sec * 1000, 2),
            "points_per_sec": round(n / sec),
            "achieved_tflops": round(rl["achieved_tflops"], 3),
            "achieved_gbps": round(rl["achieved_gbps"], 2),
            "pct_peak_flops": round(rl["pct_peak_flops"], 3),
            "pct_peak_bw": round(rl["pct_peak_bw"], 3),
        }

    best = variants["bf16"]
    print(json.dumps({
        "metric": "sa_layer_points_per_sec",
        "points": n, "samples": m, "k": k,
        "ms_per_layer": best["ms_per_layer"],
        "points_per_sec": best["points_per_sec"],
        "pct_peak_flops": best["pct_peak_flops"],
        "max_diff_bf16_vs_f32": max_diff,
        "variants": variants,
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
