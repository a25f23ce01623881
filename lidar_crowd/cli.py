"""Command-line front-end.

The counterpart of the reference's Streamlit wizard flow
(app.py:1-394 Upload -> Visualize -> Analyze -> Recommend -> Report) as a
scriptable CLI. A Streamlit front-end with the same tabs lives in
``app.py`` (gated on streamlit being installed).

Commands:
  lidar-crowd analyze <cloud> [--report out.html] [--json out.json]
                      [--variant monolith|modular] [--store db.sqlite]
  lidar-crowd sample  [--points N] [--out venue.npy]
  lidar-crowd bench   [--points N]
  lidar-crowd info    <cloud>
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lidar-crowd",
        description="LiDAR crowd analytics")
    sub = p.add_subparsers(dest="command", required=True)

    a = sub.add_parser("analyze", help="run the full analytics pipeline")
    a.add_argument("cloud", help="point cloud file "
                   "(csv/xyz/txt/npy/pcd/ply/las) or 'sample'")
    a.add_argument("--variant", choices=["monolith", "modular"],
                   default="monolith")
    a.add_argument("--report", help="write HTML report to this path")
    a.add_argument("--pdf", dest="pdf_out",
                   help="write a multi-page PDF report to this path")
    a.add_argument("--json", dest="json_out",
                   help="write results JSON to this path")
    a.add_argument("--store", help="persist results: SQLite path or "
                   "postgres:// DSN (reference app_with_db.py lifecycle)")
    a.add_argument("--fallback-cpu", action="store_true",
                   help="degrade to the CPU oracle if the device fails "
                        "(utils/resilience.FallbackPipeline)")
    a.add_argument("--event", default="", help="event name for the store")
    a.add_argument("--no-figures", action="store_true",
                   help="skip figure rendering in the report")
    a.add_argument("--downsample", type=float, default=None,
                   metavar="FACTOR",
                   help="random-downsample to this fraction before "
                        "analysis (reference downsample_point_cloud "
                        "semantics, data_processing.py:231-249)")
    a.add_argument("--voxel", type=float, default=None, metavar="SIZE",
                   help="voxel-grid downsample (one point per SIZE-m "
                        "voxel, on device) before analysis")
    a.add_argument("--neural", nargs="?", const="default", default=None,
                   metavar="CKPT",
                   help="serve with CrowdNet (one forward pass) "
                        "instead of the analytic pipeline; optional "
                        "checkpoint path (default: packaged tiny ckpt)")

    s = sub.add_parser("sample", help="generate the synthetic venue")
    s.add_argument("--points", type=int, default=10_000)
    s.add_argument("--out", default="venue.npy")

    b = sub.add_parser("bench", help="quick pipeline benchmark")
    b.add_argument("--points", type=int, default=100_000)

    i = sub.add_parser("info", help="inspect a point cloud file")
    i.add_argument("cloud")

    t = sub.add_parser(
        "train", help="distil the analytic pipeline into CrowdNet")
    t.add_argument("--out", default="crowdnet.npz",
                   help="portable checkpoint artifact to write")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--points", type=int, default=4096,
                   help="points per training venue (static capacity)")
    t.add_argument("--grid", type=int, default=32, help="BEV grid size")
    t.add_argument("--sa1", type=int, default=512,
                   help="SA1 FPS sample count")
    t.add_argument("--sa2", type=int, default=128,
                   help="SA2 FPS sample count")
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--bf16", action="store_true",
                   help="bf16 matmul operands, f32 accumulation")
    t.add_argument("--remat", action="store_true",
                   help="rematerialise SA layers (memory for FLOPs)")
    t.add_argument("--eval-venues", type=int, default=8,
                   help="held-out venues for the final metrics")
    t.add_argument("--orbax-dir", default=None,
                   help="also save a resumable Orbax train-state here")

    q = sub.add_parser("analyze-seq",
                       help="temporal analysis of a frame sequence")
    q.add_argument("frames", nargs="+",
                   help="point cloud files in time order (>=2)")
    q.add_argument("--dt", type=float, default=1.0,
                   help="seconds between frames")
    q.add_argument("--report", help="write HTML report to this path")
    return p


def _load(path: str) -> np.ndarray:
    from lidar_crowd.synthetic import sample_venue
    from lidar_crowd.utils import io as pio
    if path == "sample":
        return sample_venue()
    return pio.load_points(path)


def cmd_analyze(args) -> int:
    from lidar_crowd.config import (
        MODULAR_CONFIG, MONOLITH_CONFIG)

    points = _load(args.cloud)
    if getattr(args, "downsample", None):
        from lidar_crowd.compat import (
            downsample_point_cloud)
        points = downsample_point_cloud(points, args.downsample)
        print(f"downsampled to {len(points):,} points "
              f"(factor {args.downsample})")
    if getattr(args, "voxel", None):
        import jax.numpy as jnp

        from lidar_crowd.ops.sampling import (
            voxel_downsample)
        p = jnp.asarray(points, jnp.float32)
        _, keep = voxel_downsample(p, jnp.ones(len(points), bool),
                                   args.voxel)
        points = points[np.asarray(keep)]
        print(f"voxel-downsampled to {len(points):,} points "
              f"({args.voxel} m voxels)")
    cfg = MONOLITH_CONFIG if args.variant == "monolith" else MODULAR_CONFIG
    t0 = time.time()
    if getattr(args, "neural", None) is not None:
        from lidar_crowd.neural import (
            NeuralPipeline)
        ckpt = None if args.neural == "default" else args.neural
        pipe = NeuralPipeline(ckpt, config=cfg)
    else:
        from lidar_crowd.pipeline import Pipeline
        pipe = Pipeline(cfg)
        if getattr(args, "fallback_cpu", False):
            from lidar_crowd.utils.resilience \
                import FallbackPipeline
            pipe = FallbackPipeline(pipe)
    out = pipe.analyze(points)
    dt = time.time() - t0
    if out.get("degraded"):
        print("WARNING: device unavailable — results computed by the "
              "CPU oracle fallback", file=sys.stderr)

    d, f, r = out["density"], out["flow"], out["recommendations"]
    print(f"Analyzed {len(points):,} points in {dt:.2f}s "
          f"({len(points) / dt:,.0f} pts/s incl. compile)")
    print(f"  people detected : {d['total_people']}")
    print(f"  avg / max density: {d['avg_density']:.2f} / "
          f"{d['max_density']:.2f} people/m²")
    print(f"  avg speed       : {f['avg_speed']:.2f} m/s "
          f"(dominant {f['dominant_direction']})")
    print(f"  hotspots        : {len(d['hotspots'])}")
    print(f"  bottlenecks     : {len(f['bottlenecks'])}")
    print(f"  issues/actions  : {len(r['issues'])}/{len(r['actions'])}")

    if args.json_out:
        payload = {
            "density": {k: v for k, v in d.items()
                        if k not in ("density_map", "density_grid")},
            "flow": {k: v for k, v in f.items() if k != "flow_vectors"},
            "recommendations": r,
        }
        with open(args.json_out, "w") as fh:
            json.dump(payload, fh, indent=2, default=_np_default)
        print(f"  results JSON    : {args.json_out}")

    if args.report:
        from lidar_crowd.utils.report import (
            generate_report)
        html = generate_report(
            d, f, r,
            processed_summary={"source": args.cloud,
                               "points": len(points)},
            include_figures=not args.no_figures)
        with open(args.report, "w") as fh:
            fh.write(html)
        print(f"  HTML report     : {args.report}")

    if getattr(args, "pdf_out", None):
        from lidar_crowd.utils.report import (
            generate_pdf_report)
        generate_pdf_report(
            args.pdf_out, d, f, r,
            processed_summary={"source": args.cloud,
                               "points": len(points)})
        print(f"  PDF report      : {args.pdf_out}")

    if args.store:
        # open_store routes postgres:// DSNs to PostgresStore
        # (store.py:335-346); everything else is a SQLite path
        from lidar_crowd.utils.store import (
            open_store)
        store = open_store(args.store)
        eid = store.create_event(args.event or args.cloud)
        aid = store.create_analysis(event_id=eid,
                                    point_summary={"n": len(points)})
        store.save_density_results(
            aid, {k: v for k, v in d.items()
                  if k not in ("density_map", "density_grid")})
        store.save_flow_results(
            aid, {k: v for k, v in f.items() if k != "flow_vectors"})
        store.save_recommendations(aid, r)
        if args.report:
            with open(args.report) as fh:
                store.save_report(aid, fh.read(), title=args.cloud)
        store.close()
        print(f"  stored analysis : id {aid} in {args.store}")
    return 0


def cmd_sample(args) -> int:
    from lidar_crowd.synthetic import (
        sample_venue, scaled_venue)
    from lidar_crowd.utils import io as pio
    pts = (sample_venue() if args.points == 10_000
           else scaled_venue(args.points))
    pio.save_points(args.out, pts)
    print(f"wrote {len(pts):,} points to {args.out}")
    return 0


def cmd_bench(args) -> int:
    import jax

    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import scaled_venue
    from lidar_crowd.types import PointCloud

    pts = scaled_venue(args.points)
    pipe = Pipeline()
    cfg = pipe.fit_capacity(pts)
    clouds = [PointCloud.from_numpy(pts + i * 1e-4,
                                    cfg.capacity.max_points)
              for i in range(4)]
    t0 = time.time()
    r = jax.block_until_ready(pipe.analyze_device(clouds[0], cfg))
    people = int(r[2].density.total_people)
    print(f"compile+first: {time.time() - t0:.1f}s "
          f"(people={people}, device={jax.devices()[0]})")
    t0 = time.time()
    for c in clouds:
        r = pipe.analyze_device(c, cfg)
    jax.block_until_ready(r)
    dt = (time.time() - t0) / len(clouds)
    print(f"steady-state : {dt * 1000:.1f} ms/cloud -> "
          f"{args.points / dt:,.0f} points/s")
    return 0


def cmd_train(args) -> int:
    import jax

    from lidar_crowd.models import train as T

    cfg = T.TrainConfig(
        batch_size=args.batch_size, n_points=args.points, grid=args.grid,
        sa1_samples=args.sa1, sa2_samples=args.sa2,
        learning_rate=args.lr, seed=args.seed, bf16=args.bf16,
        remat=args.remat)
    print(f"training CrowdNet on {jax.devices()[0]} "
          f"({args.steps} steps, batch {cfg.batch_size} x "
          f"{cfg.n_points} pts, grid {cfg.grid})")
    t0 = time.time()
    state, metrics = T.fit(cfg, args.steps)
    dt = time.time() - t0
    print(f"trained in {dt:.1f}s "
          f"({args.steps * cfg.batch_size / dt:.1f} venues/s); "
          f"final loss {metrics['loss']:.4f}")

    ev = T.evaluate(state.params, cfg, n_venues=args.eval_venues)
    print(f"held-out: density MAE {ev['density_mae']:.4f} "
          f"(zero-predictor {ev['density_mae_zero']:.4f}), "
          f"flow MSE {ev['flow_mse']:.4f}, "
          f"people count rel-err {ev['people_rel_err']:.1%}")

    T.save_params_npz(args.out, state.params, cfg)
    print(f"checkpoint      : {args.out}")
    if args.orbax_dir:
        import os
        T.save_checkpoint(os.path.abspath(args.orbax_dir), state)
        print(f"orbax state     : {args.orbax_dir}")
    return 0


def cmd_analyze_seq(args) -> int:
    from lidar_crowd.pipeline import Pipeline

    frames = [_load(f) for f in args.frames]
    if len(frames) < 2:
        print("error: need at least two frames", file=sys.stderr)
        return 2
    pipe = Pipeline()
    out = pipe.analyze_sequence(frames, dt=args.dt)
    d, f = out["density"], out["flow"]
    print(f"Tracked {len(frames)} frames (dt={args.dt}s)")
    print(f"  people detected : {d['total_people']}")
    print(f"  measured speed  : {f['avg_speed']:.2f} m/s "
          f"(dominant {f['dominant_direction']})")
    print(f"  bottlenecks     : {len(f['bottlenecks'])}")
    if args.report:
        from lidar_crowd.utils.report import (
            generate_report)
        html = generate_report(d, f, out["recommendations"],
                               processed_summary={
                                   "frames": len(frames),
                                   "dt_s": args.dt})
        with open(args.report, "w") as fh:
            fh.write(html)
        print(f"  HTML report     : {args.report}")
    return 0


def cmd_info(args) -> int:
    pts = _load(args.cloud)
    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    print(f"{args.cloud}: {len(pts):,} points")
    print(f"  x: [{mins[0]:.2f}, {maxs[0]:.2f}]  "
          f"y: [{mins[1]:.2f}, {maxs[1]:.2f}]  "
          f"z: [{mins[2]:.2f}, {maxs[2]:.2f}]")
    return 0


def _np_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(str(type(o)))


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        return {"analyze": cmd_analyze, "sample": cmd_sample,
                "bench": cmd_bench, "info": cmd_info,
                "train": cmd_train,
                "analyze-seq": cmd_analyze_seq}[args.command](args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
        return 2
    except Exception as e:
        from lidar_crowd.utils.io import (
            LoaderError)
        if isinstance(e, LoaderError):
            print(f"error: {e}", file=sys.stderr)
            return 2
        raise


if __name__ == "__main__":
    sys.exit(main())
