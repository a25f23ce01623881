#!/usr/bin/env python
"""Dissect dbscan_columns cost at scale: grid build, adjacency pass,
per-sweep cost, and the realised sweep count.

Usage: python benchmarks/profile_clustering.py [--points 1000000]
"""

from __future__ import annotations

import argparse
import functools
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lidar_crowd.config import MONOLITH_CONFIG
    from lidar_crowd.ops import clustering, columns
    from lidar_crowd.pipeline import (
        Pipeline, enable_compilation_cache)
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.utils.profiling import (
        device_timer)

    enable_compilation_cache()
    n = args.points
    pts_np = scaled_venue(n)
    pipe = Pipeline()
    cfg = pipe.fit_capacity(pts_np)
    cap = cfg.capacity
    eps = cfg.preprocess.dbscan_eps
    ms = cfg.preprocess.dbscan_min_samples
    ncx, ncy = cap.cluster_cells_x, cap.cluster_cells_y
    ccap = cap.cluster_column_cap
    print(json.dumps({"ncx": ncx, "ncy": ncy, "column_cap": ccap,
                      "cluster_capacity": cap.cluster_capacity}), flush=True)

    # emulate the compacted non-ground buffer: ~70% of points, z above
    # ground percentile — just use all points above their 30th z-percentile
    z = pts_np[:, 2]
    ng = z > np.percentile(z, 30)
    sel = pts_np[ng]
    buf = cap.cluster_capacity
    m = min(len(sel), buf)
    pad = np.zeros((buf, 3), np.float32)
    pad[:m] = sel[:m]
    mask_np = np.zeros(buf, bool)
    mask_np[:m] = True

    def mk(i):
        return (jnp.asarray(pad + i * 1e-4), jnp.asarray(mask_np))

    INT_MAX = clustering.INT_MAX
    stripe = max(8, min(64, ncx // 8))

    @jax.jit
    def prog_grid(p, mk_):
        g = columns.build_column_grid(p, mk_, min_cell=eps, ncx=ncx,
                                      ncy=ncy, cap=ccap)
        return g.overflow, g.cell

    @jax.jit
    def prog_adj(p, mk_):
        g = columns.build_column_grid(p, mk_, min_cell=eps, ncx=ncx,
                                      ncy=ncy, cap=ccap)
        counts = columns.column_counts(g, eps, stripe=stripe)
        return jnp.sum(counts), g.overflow

    @jax.jit
    def prog_full(p, mk_):
        labels, n_clusters, overflow = clustering.dbscan_columns(
            p, mk_, eps, ms, ncx=ncx, ncy=ncy, column_cap=ccap,
            max_iters=cap.max_cc_iters)
        return n_clusters, overflow

    @jax.jit
    def prog_iters(p, mk_):
        """dbscan_columns clone that returns the realised sweep count."""
        g = columns.build_column_grid(p, mk_, min_cell=eps, ncx=ncx,
                                      ncy=ncy, cap=ccap)
        counts = columns.column_counts(g, eps, stripe=stripe)
        valid_int = g.table_valid[1:-1, 1:-1]
        core_int = valid_int & (counts >= ms)
        core_pad = columns.pad_interior(core_int, False)
        ptidx_int = g.table_ptidx[1:-1, 1:-1]
        labels0 = jnp.where(core_int, ptidx_int, INT_MAX)
        pos_by_point = g.point_pos
        padded_size = g.table_ptidx.size
        nn = p.shape[0]

        def to_point_order(labels_int):
            flat = jnp.concatenate(
                [columns.pad_interior(labels_int, INT_MAX).reshape(-1),
                 jnp.array([INT_MAX], jnp.int32)])
            return flat[jnp.clip(pos_by_point, 0, padded_size)]

        def jump(labels_int, labels_by_point):
            safe = jnp.clip(labels_int, 0, nn - 1)
            hop = labels_by_point[safe]
            ok = (labels_int != INT_MAX) & (hop != INT_MAX)
            return jnp.where(ok, jnp.minimum(labels_int, hop), labels_int)

        def sweep(state):
            labels, _, it = state
            nbr_min = columns.column_min_label(
                g, columns.pad_interior(labels, INT_MAX), core_pad, eps,
                INT_MAX, stripe=stripe)
            new = jnp.where(core_int, jnp.minimum(labels, nbr_min), labels)
            for _ in range(4):
                new = jump(new, to_point_order(new))
            return new, jnp.any(new != labels), it + 1

        labels_int, _, iters = jax.lax.while_loop(
            lambda s: s[1] & (s[2] < cap.max_cc_iters), sweep,
            (labels0, jnp.asarray(True), jnp.asarray(0)))
        return iters

    for name, fn, pull in (
            ("grid_build", prog_grid, lambda r: r[0]),
            ("grid+adjacency", prog_adj, lambda r: r[0]),
            ("full_dbscan", prog_full, lambda r: r[0]),
            ("sweep_count", prog_iters, lambda r: r)):
        t0 = time.time()
        s = device_timer(fn, mk, iters=args.iters, warmup=1)
        r = fn(*mk(0))
        val = int(np.asarray(pull(r)))
        print(json.dumps({name: {"s": round(s, 4), "value": val,
                                 "compile_s": round(
                                     time.time() - t0, 1)}}), flush=True)


if __name__ == "__main__":
    main()
