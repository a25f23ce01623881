#!/usr/bin/env python
"""Time the plain jnp paths at venue scale, and the centroid candidates.

Prints one JSON line per measurement:
  - device identity and what this machine's Python can import;
  - a large bf16 matmul and a device copy, as attainable peaks;
  - column-grid clustering (``dbscan_labels``) on the non-ground points
    of a 1M- and a 10M-point venue, at the pipeline's capacities;
  - density on the 1M venue's people: brute ``lax.map`` vs bucketed;
  - segment means two ways — ``jax.ops.segment_sum`` (atomic
    scatter-add) and the pipeline's stable sort + compensated prefix +
    scatter placement (``clustering._centroids_sorted``) — timed, run
    twice for determinism, and (at 1M) compared bit for bit with the
    CPU device;
  - the full device program (``analyze_device``) on the 10M venue.

Usage: python benchmarks/plain_paths.py [--small]
(``--small`` shrinks every size, for a rehearsal on the CPU.)
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import time

import numpy as np


def emit(name, **fields):
    print(json.dumps({"measure": name, **fields}), flush=True)


def timed_ms(fn, args_list):
    """Median ms over calls on distinct inputs after one warm-up call."""
    from lidar_crowd.utils.profiling import device_timer
    return 1000.0 * device_timer(fn, lambda i: args_list[i],
                                 iters=len(args_list) - 1)


def seg_sum_means(points, labels, k):
    import jax
    import jax.numpy as jnp
    seg = jnp.where(labels >= 0, labels, k)
    s = jax.ops.segment_sum(points, seg, num_segments=k + 1)[:k]
    c = jax.ops.segment_sum(jnp.ones(points.shape[0], points.dtype), seg,
                            num_segments=k + 1)[:k]
    return s / jnp.maximum(c, 1.0)[:, None]


def sorted_scatter_means(points, labels, k):
    import jax.numpy as jnp

    from lidar_crowd.ops import clustering as cl
    seg = jnp.where(labels >= 0, labels, k).astype(jnp.int32)
    s, c = cl._centroids_sorted(points, seg, k)
    return s / jnp.maximum(c, 1.0)[:, None]


CENTROID_PATHS = {"segment_sum": seg_sum_means,
                  "sort_scatter": sorted_scatter_means}


def centroid_compare(tag, pts, labels, k, with_cpu):
    import jax
    import jax.numpy as jnp
    p, lab = jnp.asarray(pts), jnp.asarray(labels)
    ok = labels >= 0
    cnt = np.bincount(labels[ok], minlength=k)
    want = np.stack([np.bincount(labels[ok], weights=pts[ok, i]
                                 .astype(np.float64), minlength=k)
                     for i in range(3)], 1) / np.maximum(cnt, 1)[:, None]
    live = cnt > 0
    for name, fn in CENTROID_PATHS.items():
        f = jax.jit(fn, static_argnums=2)
        a = np.asarray(f(p, lab, k))
        b = np.asarray(f(p, lab, k))
        fields = {"rows": len(pts), "segments": int(live.sum()),
                  "ms": timed_ms(f, [(p + i * 1e-6, lab, k)
                                     for i in range(4)]),
                  "run_to_run_identical": bool(np.array_equal(a, b)),
                  "slots_differing_between_runs":
                      int((a != b).any(axis=1).sum()),
                  "max_abs_err_vs_f64_m":
                      float(np.abs(a[live] - want[live]).max())}
        if with_cpu:
            with jax.default_device(jax.devices("cpu")[0]):
                c = np.asarray(jax.jit(fn, static_argnums=2)(
                    jnp.asarray(pts), jnp.asarray(labels), k))
            fields["slots_differing_from_cpu"] = int(
                (a != c).any(axis=1).sum())
        emit(f"centroids_{tag}_{name}", **fields)


def venue_stage(n_points, small):
    import jax
    import jax.numpy as jnp

    from lidar_crowd import preprocess as pp
    from lidar_crowd.models import density as dm
    from lidar_crowd.ops import clustering
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.types import PointCloud

    pts = scaled_venue(n_points)
    pipe = Pipeline()
    cfg = pipe.fit_capacity(pts)
    cap, pc = cfg.capacity, cfg.preprocess
    cloud = PointCloud.from_numpy(pts, cap.max_points)
    processed = jax.jit(functools.partial(pp.preprocess, config=cfg))(cloud)
    keep = np.asarray(processed.mask & ~processed.ground_mask)
    ng = np.asarray(processed.points)[keep]
    buf = np.zeros((cap.cluster_capacity, 3), np.float32)
    m = min(len(ng), cap.cluster_capacity)
    buf[:m] = ng[:m]
    bmask = np.arange(cap.cluster_capacity) < m
    cluster = jax.jit(lambda p, mk: clustering.dbscan_labels(
        p, mk, pc.dbscan_eps, pc.dbscan_min_samples,
        ncx=cap.cluster_cells_x, ncy=cap.cluster_cells_y,
        column_cap=cap.cluster_column_cap, max_iters=cap.max_cc_iters))
    res = cluster(jnp.asarray(buf), jnp.asarray(bmask))
    ms = timed_ms(cluster, [(jnp.asarray(buf + i * 1e-4), jnp.asarray(bmask))
                            for i in range(3)])
    emit(f"dbscan_columns_{n_points}", points=int(m),
         buffer=cap.cluster_capacity,
         cells=[cap.cluster_cells_x, cap.cluster_cells_y],
         column_cap=cap.cluster_column_cap, clusters=int(res[1]),
         overflow=int(res[2]), ms=ms)

    people = jax.jit(functools.partial(dm.extract_people, config=cfg))(
        processed)
    origin = jnp.stack([processed.mins[0], processed.mins[1]])
    dens = cfg.density
    gx, gy = cap.grid_cells_x, cap.grid_cells_y
    nxy = (jnp.asarray(gx, jnp.int32), jnp.asarray(gy, jnp.int32))
    grids = {}
    for name, bcap in (("bucketed", cap.density_bucket_cap),
                       ("brute_lax_map", 0)):
        if name == "brute_lax_map" and n_points > 2_000_000 and not small:
            continue  # ~1e12 pair tests at the 10M venue
        f = jax.jit(lambda ppl, bcap=bcap: dm.radius_count_grid(
            ppl, origin, *nxy, gx, gy, dens.grid_size, dens.radius,
            bucket_cap=bcap))
        grids[name] = np.asarray(f(people)[0])
        emit(f"density_{name}_{n_points}", cells=gx * gy,
             people_capacity=cap.max_people,
             people=int(np.asarray(people.count)),
             ms=timed_ms(f, [(people,)] * 4))
    if len(grids) == 2:
        emit(f"density_paths_agree_{n_points}",
             identical=bool(np.array_equal(*grids.values())))

    t_first = time.perf_counter()
    jax.block_until_ready(pipe.analyze_device(cloud, cfg))
    first_s = time.perf_counter() - t_first
    clouds = [PointCloud.from_numpy(pts + i * 1e-4, cap.max_points)
              for i in range(3)]
    emit(f"analyze_device_{n_points}", first_call_s=first_s,
         ms=timed_ms(lambda c: pipe.analyze_device(c, cfg),
                     [(c,) for c in clouds]))
    return processed, cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    mods = {}
    for mod in ("flax", "optax", "orbax.checkpoint", "sklearn", "scipy",
                "chex", "einops"):
        try:
            mods[mod] = getattr(importlib.import_module(mod),
                                "__version__", "yes")
        except ImportError as e:
            mods[mod] = f"missing: {e}"
    emit("environment", jax=jax.__version__, platform=dev.platform,
         kind=dev.device_kind, count=len(jax.devices()), imports=mods)

    n = 1024 if args.small else 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda x, y: jnp.dot(x, y,
                                      preferred_element_type=jnp.float32))
    ms = timed_ms(mm, [(a, a)] * 6)
    emit("bf16_matmul", n=n, ms=ms, tflops=2 * n ** 3 / ms / 1e9)
    big = jnp.ones((1 << (20 if args.small else 28),), jnp.float32)
    cp = jax.jit(lambda x: x + 1.0)
    ms = timed_ms(cp, [(big,)] * 6)
    emit("copy", bytes=2 * big.nbytes, ms=ms,
         gbps=2 * big.nbytes / ms / 1e6)

    sizes = (60_000, 400_000) if args.small else (1_000_000, 10_000_000)
    processed, cfg = venue_stage(sizes[0], args.small)
    pts = np.asarray(processed.points)
    labels = np.asarray(processed.labels)
    centroid_compare(f"{sizes[0]}_pipeline_labels", pts, labels,
                     cfg.capacity.max_people, with_cpu=True)
    venue_stage(sizes[1], args.small)

    rows, segs, k = ((400_000, 50_000, 65_536) if args.small
                     else (10_485_760, 1_300_000, 1_310_720))
    rng = np.random.default_rng(0)
    big_pts = rng.uniform(-512.0, 512.0, (rows, 3)).astype(np.float32)
    n_noise = rows // 4
    lab = np.concatenate([np.arange(segs),
                          rng.integers(0, segs, rows - segs - n_noise),
                          np.full(n_noise, -1)]).astype(np.int32)
    centroid_compare(f"{rows}_random_labels", big_pts,
                     lab[rng.permutation(rows)], k, with_cpu=False)


if __name__ == "__main__":
    main()
