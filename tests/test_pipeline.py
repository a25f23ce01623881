"""Golden-pipeline parity: the full jitted pipeline vs the CPU oracle on
the seed-42 fixture (SURVEY.md §4 test strategy, level (b))."""

import numpy as np
import pytest

from lidar_crowd.config import (
    MODULAR_CONFIG, MONOLITH_CONFIG)
from lidar_crowd.pipeline import Pipeline


@pytest.fixture(scope="module")
def monolith_out(fixture_points):
    return Pipeline(MONOLITH_CONFIG).analyze(fixture_points)


@pytest.fixture(scope="module")
def modular_out(fixture_points):
    return Pipeline(MODULAR_CONFIG).analyze(fixture_points)


class TestMonolithParity:
    def test_people_count(self, monolith_out, oracle_monolith):
        assert (monolith_out["density"]["total_people"]
                == oracle_monolith["density"]["total_people"] == 446)

    def test_density_stats(self, monolith_out, oracle_monolith):
        d, od = monolith_out["density"], oracle_monolith["density"]
        assert abs(d["avg_density"] - od["avg_density"]) < 1e-5
        assert abs(d["max_density"] - od["max_density"]) < 1e-6

    def test_density_grid_exact(self, monolith_out, oracle_monolith):
        g = monolith_out["density"]["density_grid"]
        og = oracle_monolith["density"]["density_grid"]
        assert g.shape == og.shape
        assert np.abs(g - og).max() == 0.0  # counts/4 are exact in f32

    def test_hotspots(self, monolith_out, oracle_monolith):
        hs = monolith_out["density"]["hotspots"]
        ohs = oracle_monolith["density"]["hotspots"]
        assert len(hs) == len(ohs)
        for a, b in zip(hs, ohs):
            assert abs(a["x"] - b["x"]) < 1e-4
            assert abs(a["y"] - b["y"]) < 1e-4
            assert abs(a["density"] - b["density"]) < 1e-6

    def test_flow_stats(self, monolith_out, oracle_monolith):
        f, of = monolith_out["flow"], oracle_monolith["flow"]
        assert abs(f["avg_speed"] - of["avg_speed"]) < 1e-5
        assert f["dominant_direction"] == of["dominant_direction"]

    def test_flow_field_values(self, monolith_out, oracle_monolith):
        f, of = monolith_out["flow"], oracle_monolith["flow"]
        ours = f["flow_vectors"]
        ref = of["flow_vectors"]
        assert ours["positions"].shape == ref["positions"].shape
        np.testing.assert_allclose(ours["positions"], ref["positions"],
                                   atol=1e-4)
        np.testing.assert_allclose(ours["vectors"], ref["vectors"],
                                   atol=5e-5)
        np.testing.assert_allclose(ours["magnitudes"], ref["magnitudes"],
                                   atol=5e-5)

    def test_bottlenecks(self, monolith_out, oracle_monolith):
        bs = monolith_out["flow"]["bottlenecks"]
        obs = oracle_monolith["flow"]["bottlenecks"]
        assert len(bs) == len(obs)
        for a, b in zip(bs, obs):
            assert abs(a["x"] - b["x"]) < 1e-4
            assert abs(a["y"] - b["y"]) < 1e-4
            assert a["severity"] == b["severity"]

    def test_recommendations_match_oracle_inputs(self, monolith_out,
                                                 oracle_monolith):
        from lidar_crowd.utils.recommendations \
            import generate_recommendations
        ours = monolith_out["recommendations"]
        oref = generate_recommendations(oracle_monolith["density"],
                                        oracle_monolith["flow"])
        assert len(ours["issues"]) == len(oref["issues"])
        assert len(ours["actions"]) == len(oref["actions"])
        assert [i["severity"] for i in ours["issues"]] == \
               [i["severity"] for i in oref["issues"]]
        assert len(ours["opportunities"]) == 4


class TestModularParity:
    def test_people_count(self, modular_out, oracle_modular):
        assert (modular_out["density"]["total_people"]
                == oracle_modular["density"]["total_people"])

    def test_density_grid(self, modular_out, oracle_modular):
        g = modular_out["density"]["density_map"]
        og = oracle_modular["density"]["density_map"]
        assert g.shape == og.shape
        # histogram counts are integers/g^2 — require near-exactness; a
        # people centroid sitting on a cell edge may shift one bin in f32
        assert np.abs(g - og).mean() < 0.01

    def test_density_stats(self, modular_out, oracle_modular):
        d, od = modular_out["density"], oracle_modular["density"]
        assert abs(d["avg_density"] - od["avg_density"]) < 1e-3
        assert abs(d["max_density"] - od["max_density"]) < 1e-6

    def test_flow(self, modular_out, oracle_modular):
        f, of = modular_out["flow"], oracle_modular["flow"]
        assert abs(f["avg_speed"] - of["avg_speed"]) < 1e-5
        assert f["dominant_direction"] == of["dominant_direction"]
        assert len(f["bottlenecks"]) == len(of["bottlenecks"])
        for a, b in zip(f["bottlenecks"], of["bottlenecks"]):
            assert a["severity"] == b["severity"]


class TestEdgeCases:
    def test_empty_scene_no_people(self):
        # pure ground plane -> no clusters -> empty results path
        rng = np.random.RandomState(0)
        pts = np.column_stack([rng.uniform(-5, 5, 2000),
                               rng.uniform(-5, 5, 2000),
                               rng.normal(0, 0.01, 2000)]).astype(np.float32)
        out = Pipeline(MONOLITH_CONFIG).analyze(pts)
        f = out["flow"]
        assert f["dominant_direction"] in ("N/A", "E", "NE", "N", "NW", "W",
                                           "SW", "S", "SE")
        assert out["density"]["total_people"] >= 0

    def test_small_cloud(self):
        pts = np.random.RandomState(1).uniform(-1, 1, (50, 3)).astype(
            np.float32)
        out = Pipeline(MONOLITH_CONFIG).analyze(pts)
        assert "density" in out and "flow" in out


class TestPeopleCapacityOverflow:
    """A venue with more clusters than the people capacity must not
    silently undercount (reference never drops a cluster,
    utils/data_processing.py:251-280)."""

    @staticmethod
    def _dense_venue():
        # 256 points: 77 ground (z=0, lowest-30% split) + 179 person
        # points in 35 tight blobs (5+ pts each, eps=0.3, min_samples=5).
        # fit_capacity gives max_people = pow2(256 // 8) = 32 < 35.
        rng = np.random.RandomState(7)
        ground = np.column_stack([
            rng.uniform(-10, 10, 77), rng.uniform(-10, 10, 77),
            np.zeros(77)])
        blobs = []
        centers = [(-10 + 3.0 * (i % 7), -10 + 3.0 * (i // 7))
                   for i in range(35)]
        for k, (cx, cy) in enumerate(centers):
            m = 9 if k == 0 else 5  # 34*5 + 9 = 179
            blobs.append(np.column_stack([
                cx + rng.uniform(-0.05, 0.05, m),
                cy + rng.uniform(-0.05, 0.05, m),
                np.full(m, 1.5)]))
        return np.concatenate([ground] + blobs).astype(np.float32)

    def test_device_path_flags_overflow(self):
        from lidar_crowd.types import PointCloud
        pts = self._dense_venue()
        pipe = Pipeline(MONOLITH_CONFIG.with_capacity(max_people=4))
        cfg = pipe.fit_capacity(pts)
        assert cfg.capacity.max_people == 32
        cloud = PointCloud.from_numpy(pts, cfg.capacity.max_points)
        _, people, _ = pipe.analyze_device(cloud, cfg)
        assert int(people.overflow) == 3  # 35 clusters, capacity 32
        assert int(people.count) == 32    # the undercount the guard fixes

    def test_analyze_retries_to_exact_count(self):
        pts = self._dense_venue()
        pipe = Pipeline(MONOLITH_CONFIG.with_capacity(max_people=4))
        out = pipe.analyze(pts)
        assert out["density"]["total_people"] == 35
        assert int(out["people"].overflow) == 0
