#!/usr/bin/env python
"""Smoke check: the analytics engine runs on NVIDIA GPUs and is right there.

Drives the main path through the entry point a user calls
(``Pipeline.analyze``) at venue scale and checks each result against a
reference: the seed-42 golden values, the CPU device running the same
program in this process, or NumPy float64. Each phase prints one JSON
line; a mismatch or an exception exits non-zero before the last line,
which is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:
    python chip_smoke.py           # phases 0-4, one card
    python chip_smoke.py --multi   # phase 5 only: the sharded paths over
                                   # a 4-card mesh against one card

There is no CPU fallback: without a GPU it exits with code 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GOLDEN = {  # seed-42 fixture, bit-parity with the CPU reference oracle
    "total_people": 446, "max_density": 3.5, "dominant_direction": "E",
    "n_hotspots": 5, "first_hotspot": (5.5, -10.5),
    "severities": [8, 8, 8, 7, 7],
    "avg_density": 0.4958, "avg_speed": 1.2617,
}
# avg_density and avg_speed are quoted to 4 decimals; the first hotspot
# is a cell centre quoted to 0.1 m
GOLDEN_TOL = {"avg": 1e-4, "hotspot_m": 0.01}
# Centroids of the 10.49M-row phase span +-512 m, where one f32 ulp is
# 6.1e-5 m; the compensated sums put each mean within a few ulps.
CENTROID_TOL_M = 1e-3
# Cluster sums are bit-identical on every backend (stable sort, fixed
# scan tree); XLA's GPU f32 division is within 2 ulp of the correctly
# rounded quotient the CPU computes, so centroids may differ by that much.
POSITION_ULPS = 2.0
# The sharded and the one-card flow programs are compiled apart, and the
# GPU may contract a*b + c into an FMA in one and not the other; speeds
# and vectors may then differ by an ulp (bottleneck flags may not).
FLOW_ULPS = 2.0
# bf16 operands carry 8 mantissa bits (relative 2^-9 per rounding)
# through three layers; the pooled features agree within 2% of their
# largest magnitude.
SA_BF16_REL_TOL = 2e-2
# A GPU runs CrowdNet's f32 convs and matmuls in TF32 (10 mantissa bits)
# by default; the CPU runs them in f32.
NEURAL_REL_TOL = 1e-2


class SmokeFailure(AssertionError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def ms(fn, make_input, iters: int) -> float:
    """Median ms of ``fn(*make_input(i))``, already compiled, each call
    waited for with ``block_until_ready``."""
    from lidar_crowd.utils.profiling import device_timer
    return 1000.0 * device_timer(fn, make_input, iters=iters, warmup=0)


HERE = os.path.dirname(os.path.abspath(__file__))


def on_cpu(task: str, *args) -> dict:
    """``task(*args)``, a function of this module returning arrays, run
    by a child process on the host CPU. The child never opens the card,
    and it runs without the persistent compile cache: CPU executables
    carry the host's machine features, and a cache that outlives the
    machine could hand them to another host."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import sys, numpy as np, chip_smoke; "
            f"np.savez(sys.argv[1], **chip_smoke.{task}(*{args!r}))")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.npz")
        subprocess.run([sys.executable, "-c", code, out], cwd=HERE,
                       env=env, check=True, timeout=1200)
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


def venue_arrays(out) -> dict:
    """The census, people, density and bottlenecks of one analysis."""
    d, f, ppl = out["density"], out["flow"], out["people"]
    return {
        "census": np.asarray([d["total_people"],
                              int(out["processed"].n_clusters)]),
        "positions": np.asarray(ppl.positions)[np.asarray(ppl.mask)],
        "density_map": d["density_map"],
        "hotspots": np.asarray([[h["x"], h["y"], h["density"]]
                                for h in d["hotspots"]]).reshape(-1, 3),
        "bottlenecks": np.asarray([[b["x"], b["y"], b["severity"]]
                                   for b in f["bottlenecks"]]
                                  ).reshape(-1, 3)}


def venue_result(n_points: int) -> dict:
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    return venue_arrays(Pipeline().analyze(scaled_venue(n_points)))


def fps_result(n_points: int, n_samples: int) -> dict:
    import jax.numpy as jnp

    from lidar_crowd.ops.sampling import farthest_point_sampling
    from lidar_crowd.synthetic import scaled_venue
    pts = jnp.asarray(scaled_venue(n_points), jnp.float32)
    return {"idx": np.asarray(farthest_point_sampling(
        pts, jnp.ones(n_points, bool), n_samples))}


def crowdnet_result() -> dict:
    from lidar_crowd.neural import NeuralPipeline
    from lidar_crowd.synthetic import sample_venue
    venue = sample_venue()
    vmin = venue[:, :2].min(0).astype(np.float32)
    vsize = float((venue[:, :2].max(0) - vmin).max()) + 1e-6
    return NeuralPipeline().forward(venue, vmin, vsize)


# -- phase 0 ------------------------------------------------------------------

def phase_device(n_cards: int) -> dict:
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX backend {backend!r})")
    devs = jax.devices()
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX sees "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    emit("device", jax=jax.__version__, nvidia_smi=smi.stdout.strip(),
         xla_flags=os.environ.get("XLA_FLAGS", ""), **device)
    return device


# -- phase 1 ------------------------------------------------------------------

def phase_golden(oracle_points: int = 100_000) -> None:
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import sample_venue, scaled_venue

    out = Pipeline().analyze(sample_venue())
    d, f = out["density"], out["flow"]
    hs = d["hotspots"]
    sev = [b["severity"] for b in f["bottlenecks"]]
    g = GOLDEN
    check(d["total_people"] == g["total_people"],
          f"people {d['total_people']} != {g['total_people']}")
    check(d["max_density"] == g["max_density"],
          f"max_density {d['max_density']!r} != {g['max_density']}")
    check(f["dominant_direction"] == g["dominant_direction"],
          f"direction {f['dominant_direction']}")
    check(len(hs) == g["n_hotspots"], f"{len(hs)} hotspots")
    check(abs(hs[0]["x"] - g["first_hotspot"][0]) <= GOLDEN_TOL["hotspot_m"]
          and abs(hs[0]["y"] - g["first_hotspot"][1])
          <= GOLDEN_TOL["hotspot_m"], f"first hotspot {hs[0]}")
    check(sev == g["severities"], f"severities {sev}")
    check(abs(d["avg_density"] - g["avg_density"]) <= GOLDEN_TOL["avg"],
          f"avg_density {d['avg_density']}")
    check(abs(f["avg_speed"] - g["avg_speed"]) <= GOLDEN_TOL["avg"],
          f"avg_speed {f['avg_speed']}")
    fields = {"people": d["total_people"], "max_density": d["max_density"],
              "avg_density": d["avg_density"], "avg_speed": f["avg_speed"],
              "first_hotspot": [hs[0]["x"], hs[0]["y"]],
              "severities": sev, "tolerance": GOLDEN_TOL}

    try:
        from lidar_crowd.oracle import reference as ref
    except ImportError as e:  # scikit-learn is an optional extra
        fields["oracle"] = f"not run: {e}"
    else:
        pts = scaled_venue(oracle_points)
        ours = Pipeline().analyze(pts)["density"]
        theirs = ref.analyze(pts, variant="monolith")["density"]
        og, mg = theirs["density_grid"], ours["density_grid"]
        check(og.shape == mg.shape, f"grid shapes {mg.shape} {og.shape}")
        mae = float(np.abs(mg - og).mean())
        check(mae == 0.0, f"density MAE vs oracle {mae}")
        check(ours["total_people"] == theirs["total_people"],
              f"people {ours['total_people']} vs oracle "
              f"{theirs['total_people']}")
        fields["oracle"] = {"points": oracle_points, "density_mae": mae,
                            "people": ours["total_people"]}
    emit("golden", **fields)


# -- phase 2 ------------------------------------------------------------------

def phase_venue(n_points: int = 1_000_000, iters: int = 3) -> None:
    import jax

    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.types import PointCloud

    pts = scaled_venue(n_points)
    pipe = Pipeline()
    t0 = time.perf_counter()
    gpu = venue_arrays(pipe.analyze(pts))
    first_s = time.perf_counter() - t0
    again = venue_arrays(pipe.analyze(pts))
    cpu = on_cpu("venue_result", n_points)

    check(np.array_equal(gpu["positions"], again["positions"]),
          "people positions differ between two runs on the GPU")
    check(np.array_equal(gpu["census"], cpu["census"]),
          f"census GPU {gpu['census']} != CPU {cpu['census']}")
    posg, posc = gpu["positions"], cpu["positions"]
    ulps = np.abs(posg - posc) / np.spacing(np.abs(posc))
    check(float(ulps.max()) <= POSITION_ULPS,
          f"people positions GPU vs CPU differ by {ulps.max()} ulp")
    for key in ("density_map", "hotspots", "bottlenecks"):
        check(np.array_equal(gpu[key], cpu[key]), f"{key} GPU != CPU")

    analyze_ms = ms(lambda: pipe.analyze(pts)["people"].mask,
                    lambda i: (), iters)
    cfg = pipe.fit_capacity(pts)
    clouds = [PointCloud.from_numpy(pts + i * 1e-4, cfg.capacity.max_points)
              for i in range(iters + 1)]
    jax.block_until_ready(pipe.analyze_device(clouds[-1], cfg))
    device_ms = ms(lambda c: pipe.analyze_device(c, cfg),
                   lambda i: (clouds[i],), iters)
    emit("venue_1m", points=n_points, people=int(gpu["census"][0]),
         clusters=int(gpu["census"][1]),
         max_density=float(gpu["density_map"].max()),
         first_call_s=first_s, analyze_ms=analyze_ms,
         analyze_device_ms=device_ms, census_and_grid_equal_cpu=True,
         positions_differing_from_cpu=int((ulps > 0).any(1).sum()),
         max_position_ulps=float(ulps.max()))


# -- phase 3 ------------------------------------------------------------------

def phase_centroids(n_rows: int = 10_485_760, n_segments: int = 1_300_000,
                    capacity: int = 1_310_720, iters: int = 3) -> None:
    import jax
    import jax.numpy as jnp

    from lidar_crowd.ops.clustering import cluster_centroids

    rng = np.random.default_rng(0)
    pts = rng.uniform(-512.0, 512.0, (n_rows, 3)).astype(np.float32)
    # dense ids 0..S-1 (each present, as the pipeline's are) plus noise
    n_noise = n_rows // 4
    labels = np.concatenate([
        np.arange(n_segments),
        rng.integers(0, n_segments, n_rows - n_segments - n_noise),
        np.full(n_noise, -1)]).astype(np.int32)
    labels = labels[rng.permutation(n_rows)]

    fn = jax.jit(cluster_centroids, static_argnums=2)
    p_d, l_d = jnp.asarray(pts), jnp.asarray(labels)
    cents, valid, overflow = fn(p_d, l_d, capacity)
    cents2 = fn(p_d, l_d, capacity)[0]
    centroid_ms = ms(fn, lambda i: (p_d, l_d, capacity), iters)
    cents, valid, cents2 = (np.asarray(a) for a in (cents, valid, cents2))

    ok = labels >= 0
    cnt = np.bincount(labels[ok], minlength=capacity)
    want = np.stack([np.bincount(labels[ok], weights=pts[ok, i]
                                 .astype(np.float64), minlength=capacity)
                     for i in range(3)], 1) / np.maximum(cnt, 1)[:, None]
    check(int(overflow) == 0, f"overflow {int(overflow)}")
    check(np.array_equal(valid, cnt > 0), "valid slots != nonzero counts")
    err = float(np.abs(cents[valid] - want[valid]).max())
    check(err <= CENTROID_TOL_M, f"centroid error {err} m")
    check(np.array_equal(cents, cents2), "centroids differ between runs")
    emit("centroids", rows=n_rows, segments=n_segments, capacity=capacity,
         max_abs_err_m=err, tolerance_m=CENTROID_TOL_M, ms=centroid_ms,
         deterministic=True)


# -- phase 4 ------------------------------------------------------------------

def phase_sa_layer(n_points: int = 100_000, n_samples: int = 4096,
                   k: int = 32, radius: float = 0.6, iters: int = 3
                   ) -> None:
    import jax
    import jax.numpy as jnp

    from lidar_crowd.ops.grouping import (
        ball_group, group_features, sa_mlp_pool)
    from lidar_crowd.ops.sampling import farthest_point_sampling
    from lidar_crowd.synthetic import scaled_venue

    pts = jnp.asarray(scaled_venue(n_points), jnp.float32)
    mask = jnp.ones(n_points, bool)
    rng = np.random.default_rng(0)
    dims = [3, 32, 32, 64]
    weights = [(jnp.asarray(rng.normal(0, a ** -0.5, (a, b)), jnp.float32),
                jnp.asarray(rng.normal(0, 0.1, b), jnp.float32))
               for a, b in zip(dims[:-1], dims[1:])]

    fps = jax.jit(farthest_point_sampling, static_argnums=2)
    idx = np.asarray(fps(pts, mask, n_samples))
    idx_cpu = on_cpu("fps_result", n_points, n_samples)["idx"]
    check(np.array_equal(idx, idx_cpu), "FPS indices GPU != CPU")
    fps_ms = ms(fps, lambda i: (pts, mask, n_samples), iters)

    def layer(p, compute_dtype):
        sel = farthest_point_sampling(p, mask, n_samples)
        cents = p[sel]
        gidx, gvalid = ball_group(cents, mask[sel], p, mask, radius, k)
        g = group_features(p, None, cents, gidx, gvalid)
        return sa_mlp_pool(g, gvalid, weights, compute_dtype=compute_dtype)

    bf16 = jax.jit(lambda p: layer(p, jnp.bfloat16))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p: layer(p, jnp.float32))(pts))
    out = np.asarray(bf16(pts))
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    check(scale > 0 and err <= SA_BF16_REL_TOL * scale,
          f"bf16 SA error {err} vs scale {scale}")
    layer_ms = ms(bf16, lambda i: (pts,), iters)
    fields = {"points": n_points, "samples": n_samples, "k": k,
              "fps_ms": fps_ms, "layer_bf16_ms": layer_ms,
              "bf16_max_abs_err": err, "f32_max_abs": scale,
              "tolerance_rel": SA_BF16_REL_TOL}

    try:
        import lidar_crowd.neural  # noqa: F401
    except ImportError as e:  # flax is the optional "neural" extra
        fields["crowdnet"] = f"not run: {e}"
    else:
        got = crowdnet_result()
        want = on_cpu("crowdnet_result")
        errs = {}
        for key, w in want.items():
            e = float(np.abs(got[key] - w).max())
            check(e <= NEURAL_REL_TOL * max(1.0, float(np.abs(w).max())),
                  f"CrowdNet {key}: GPU-CPU {e}")
            errs[key] = e
        fields["crowdnet"] = {"max_abs_diff_vs_cpu": errs,
                              "tolerance_rel": NEURAL_REL_TOL}
    emit("sa_layer", **fields)


# -- phase 5 ------------------------------------------------------------------

def phase_multi(n_points: int = 1_000_000, n_cards: int = 4) -> None:
    import jax
    import jax.numpy as jnp

    from lidar_crowd.models import flow as flow_mod
    from lidar_crowd.ops.clustering import dbscan_labels
    from lidar_crowd.parallel import cluster as pcluster
    from lidar_crowd.parallel import spatial
    from lidar_crowd.parallel.mesh import make_mesh
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.types import PointCloud

    devices = jax.devices()[:n_cards]
    mesh = make_mesh((("sp", n_cards),), devices)
    pts = scaled_venue(n_points)
    pipe = Pipeline()
    cfg = pipe.fit_capacity(pts)
    cloud = PointCloud.from_numpy(pts, cfg.capacity.max_points)
    processed, people, res = jax.block_until_ready(
        pipe.analyze_device(cloud, cfg))
    check(int(processed.cluster_overflow) == 0
          and int(people.overflow) == 0
          and int(res.density.radius_overflow) == 0,
          "single-card run overflowed its capacities")
    fields = {"points": n_points, "cards": n_cards}

    # DBSCAN over the non-ground points, stripes over the mesh
    keep = np.asarray(processed.mask & ~processed.ground_mask)[:len(pts)]
    ng = pts[keep].astype(np.float32)
    pc = cfg.preprocess
    cap = cfg.capacity
    t0 = time.perf_counter()
    sharded = pcluster.sharded_dbscan(ng, pc.dbscan_eps,
                                      pc.dbscan_min_samples, mesh)
    sharded_s = time.perf_counter() - t0
    column_cap = cap.cluster_column_cap
    while True:
        single, n_clusters, overflow = dbscan_labels(
            jnp.asarray(ng), jnp.ones(len(ng), bool), pc.dbscan_eps,
            pc.dbscan_min_samples, ncx=cap.cluster_cells_x,
            ncy=cap.cluster_cells_y, column_cap=column_cap,
            max_iters=cap.max_cc_iters)
        if int(overflow) == 0:
            break
        column_cap *= 2
    single = np.asarray(single)
    reps = np.unique(sharded[sharded >= 0])
    dense = np.full(len(ng) + 1, -1, np.int64)
    dense[reps] = np.arange(len(reps))
    check(len(reps) == int(n_clusters),
          f"sharded clusters {len(reps)} != {int(n_clusters)}")
    check(np.array_equal(
        np.where(sharded >= 0, dense[np.clip(sharded, 0, len(ng))], -1),
        single), "sharded DBSCAN labels != single card")
    fields["dbscan"] = {"points": len(ng), "clusters": int(n_clusters),
                        "sharded_s": sharded_s, "bit_exact": True}

    origin = jnp.stack([processed.mins[0], processed.mins[1]])
    grid = spatial.sharded_radius_density(
        people.positions, people.mask, origin, res.density.nx,
        res.density.ny, cfg, mesh)
    check(np.array_equal(np.asarray(grid),
                         np.asarray(res.density.density_grid)),
          "sharded density grid != single card")
    fields["density"] = {"cells": int(grid.size), "bit_exact": True}

    u = jnp.asarray(flow_mod.bottleneck_uniforms(), jnp.float32)
    vec1, mag1, valid1, _, _ = jax.jit(
        flow_mod.synthesize_flow, static_argnums=2)(processed, u, cfg)
    sev1, ok1 = jax.jit(flow_mod._bottlenecks_monolith,
                        static_argnums=2)(mag1, valid1, cfg)
    vec2, mag2, valid2, sev2, ok2 = spatial.sharded_flow_and_bottlenecks(
        processed.mins[:2], processed.maxs[:2], u, cfg, mesh)
    v1 = np.asarray(valid1)
    check(np.array_equal(np.asarray(valid2), v1), "flow validity differs")
    check(np.array_equal(np.asarray(ok2), np.asarray(ok1))
          and np.array_equal(np.asarray(sev2)[np.asarray(ok2)],
                             np.asarray(sev1)[np.asarray(ok1)]),
          "sharded bottlenecks != single card")
    single = np.concatenate([np.asarray(vec1)[v1],
                             np.asarray(mag1)[v1][:, None]], 1)
    sharded = np.concatenate([np.asarray(vec2)[v1],
                              np.asarray(mag2)[v1][:, None]], 1)
    ulps = np.abs(sharded - single) / np.spacing(np.abs(single))
    check(float(ulps.max()) <= FLOW_ULPS,
          f"sharded flow differs from one card by {ulps.max()} ulp")
    fields["flow"] = {"nodes": int(v1.sum()),
                      "bit_exact": bool(np.array_equal(sharded, single)),
                      "max_ulps": float(ulps.max()),
                      "bottlenecks_equal": True}

    try:
        from lidar_crowd.models.train import TrainConfig
        from lidar_crowd.parallel.trainer import run_sharded_steps
    except ImportError as e:  # flax is the optional "neural" extra
        fields["train_step"] = f"not run: {e}"
    else:
        tcfg = TrainConfig(batch_size=4, n_points=4096, grid=32,
                           sa1_samples=512, sa2_samples=128)
        sharded_m = run_sharded_steps(
            tcfg, make_mesh((("dp", 2), ("mp", 2)), devices), n_steps=1)
        single_m = run_sharded_steps(
            tcfg, make_mesh((("dp", 1), ("mp", 1)), devices[:1]),
            n_steps=1)
        diff = abs(sharded_m["loss"] - single_m["loss"])
        check(np.isfinite(sharded_m["loss"])
              and diff <= NEURAL_REL_TOL * abs(single_m["loss"]),
              f"dp x mp loss {sharded_m['loss']} vs {single_m['loss']}")
        fields["train_step"] = {"mesh": "dp2 x mp2",
                                "loss": sharded_m["loss"],
                                "single_card_loss": single_m["loss"],
                                "tolerance_rel": NEURAL_REL_TOL}
    emit("multi", **fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths over four cards")
    args = ap.parse_args(argv)
    device = phase_device(4 if args.multi else 1)
    if args.multi:
        phase_multi()
    else:
        phase_golden()
        phase_venue()
        phase_centroids()
        phase_sa_layer()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
