"""Fixture generator determinism (app_simplified.py:994-1024 semantics)."""

import numpy as np

from lidar_crowd.synthetic import (
    sample_venue, scaled_venue)


def test_fixture_shape_and_determinism():
    a = sample_venue()
    b = sample_venue()
    assert a.shape == (10000, 3)
    np.testing.assert_array_equal(a, b)


def test_fixture_matches_reference_recipe():
    pts = sample_venue()
    # xy uniform in ±15, z in [terrain_min, 1.8]
    assert np.all(np.abs(pts[:, :2]) <= 15.0)
    assert pts[:, 2].max() <= 1.8
    assert pts[:, 2].min() >= -0.1 - 1e-9
    # people points exist (z noticeably above terrain)
    assert np.sum(pts[:, 2] > 0.2) > 100


def test_scaled_venue_sizes():
    v = scaled_venue(100_000)
    assert v.shape == (100_000, 3)
    # venue grows with sqrt(area)
    assert np.abs(v[:, :2]).max() > 40
