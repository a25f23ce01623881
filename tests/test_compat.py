"""Reference-compatible façade: the reference's exact call pattern must
work end-to-end (app.py:78-297 usage flow)."""

import numpy as np

from lidar_crowd import compat


def test_reference_call_pattern(tmp_path, fixture_points):
    # the reference's modular app flow, verbatim shape-wise
    from lidar_crowd.utils.io import save_points
    path = str(tmp_path / "venue.xyz")
    save_points(path, fixture_points)

    points = compat.load_lidar_data(path)
    assert points.shape[1] == 3

    processed = compat.preprocess_lidar_data(points)
    for key in ("points", "colors", "normals", "clusters",
                "ground_plane", "dimensions"):
        assert key in processed
    assert processed["points"].shape[0] == processed["clusters"].shape[0]
    assert set(processed["dimensions"]) >= {"x_range", "y_range",
                                            "width", "length"}

    density = compat.CrowdDensityModel().analyze(processed)
    assert density["total_people"] > 0
    assert "hotspots" in density and "density_map" in density

    flow = compat.CrowdFlowModel().analyze(processed)
    assert set(flow) >= {"flow_vectors", "avg_speed",
                         "dominant_direction", "bottlenecks"}

    recs = compat.generate_recommendations(density, flow)
    assert set(recs) == {"issues", "actions", "opportunities"}

    html = compat.generate_report(density, flow, recs,
                                  include_figures=False)
    assert html.startswith("<!DOCTYPE html>")


def test_people_positions_and_grid_density(fixture_points):
    processed = compat.preprocess_lidar_data(fixture_points)
    pos = compat.extract_people_positions(processed)
    assert pos.ndim == 2 and pos.shape[1] == 2
    gx, gy, grid = compat.calculate_grid_density(
        pos, processed["dimensions"]["x_range"],
        processed["dimensions"]["y_range"])
    assert grid.shape == (len(gx), len(gy))
    assert grid.sum() * 1.0 == len(pos)  # counts conserved


def test_downsample_semantics():
    pts = np.arange(300).reshape(100, 3).astype(float)
    np.random.seed(0)
    out = compat.downsample_point_cloud(pts, 0.25)
    assert out.shape == (25, 3)
    same = compat.downsample_point_cloud(pts, 1.0)
    assert same is pts


def test_risk_level_bands():
    m = compat.CrowdDensityModel
    assert m.calculate_risk_level(0.5) == "Low"
    assert m.calculate_risk_level(2.0) == "Moderate"
    assert m.calculate_risk_level(3.0) == "High"
    assert m.calculate_risk_level(4.5) == "Critical"
