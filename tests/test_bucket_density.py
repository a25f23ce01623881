"""Coarse-bucketed radius count (ops/bucket_density.py): bit-exactness
vs the brute-force path, overflow accounting, the size-only choice
between the two, and the pipeline-level dispatch + auto-retry."""

import numpy as np
import pytest

import jax.numpy as jnp

from lidar_crowd.models import density as D
from lidar_crowd.ops import bucket_density as bd
from lidar_crowd.types import People


def _people(pos, live):
    k = len(pos)
    mask = np.zeros(k, bool)
    mask[:live] = True
    return People(positions=jnp.asarray(pos), mask=jnp.asarray(mask),
                  z=jnp.zeros(k), overflow=jnp.asarray(0))


@pytest.mark.parametrize("seed,k,live,gx,gy,gs,r", [
    (0, 256, 200, 64, 48, 1.0, 2.0),
    (1, 512, 512, 96, 96, 0.5, 2.0),   # fractional radius/grid ratio
    (2, 128, 90, 33, 65, 1.0, 3.3),    # non-integer s, odd grid caps
    (3, 64, 0, 16, 16, 1.0, 2.0),      # no live people
])
def test_bucketed_bit_matches_brute(seed, k, live, gx, gy, gs, r):
    rng = np.random.RandomState(seed)
    span = (gx * gs, gy * gs)
    pos = (rng.uniform(0, 1, (k, 2)) * span).astype(np.float32)
    origin = jnp.asarray(np.zeros(2, np.float32))
    ppl = _people(pos, live)

    brute, ov0 = D.radius_count_grid(ppl, origin, jnp.asarray(gx),
                                     jnp.asarray(gy), gx, gy, gs, r)
    bucketed, ov = bd.radius_count_bucketed(
        ppl.positions, ppl.mask, origin, gx, gy, gs, r, bucket_cap=96)
    assert int(ov0) == 0 and int(ov) == 0
    np.testing.assert_array_equal(np.asarray(bucketed), np.asarray(brute))


def test_boundary_people_exactly_at_radius():
    """A person at f32 distance exactly r from a cell centre must count
    identically in both formulations (<= semantics, same arithmetic)."""
    gs, r = 1.0, 2.0
    origin = jnp.asarray(np.zeros(2, np.float32))
    centre = np.float32([4.5, 4.5])  # cell (4, 4) centre
    pos = np.stack([centre + [r, 0.0], centre + [0.0, -r],
                    centre + [r + 1e-3, 0.0], centre]).astype(np.float32)
    ppl = _people(pos, 4)
    brute, _ = D.radius_count_grid(ppl, origin, jnp.asarray(16),
                                   jnp.asarray(16), 16, 16, gs, r)
    bucketed, ov = bd.radius_count_bucketed(
        ppl.positions, ppl.mask, origin, 16, 16, gs, r, bucket_cap=8)
    assert int(ov) == 0
    np.testing.assert_array_equal(np.asarray(bucketed), np.asarray(brute))
    assert int(np.asarray(brute)[4, 4]) == 3  # the +1e-3 one is out


def test_overflow_counts_dropped_people():
    rng = np.random.RandomState(7)
    pos = rng.uniform(0, 4, (64, 2)).astype(np.float32)  # all in few cells
    ppl = _people(pos, 64)
    origin = jnp.asarray(np.zeros(2, np.float32))
    _, ov = bd.radius_count_bucketed(ppl.positions, ppl.mask, origin,
                                     32, 32, 1.0, 2.0, bucket_cap=4)
    assert int(ov) > 0
    full, ov2 = bd.radius_count_bucketed(ppl.positions, ppl.mask, origin,
                                         32, 32, 1.0, 2.0, bucket_cap=64)
    assert int(ov2) == 0


def test_pipeline_dispatch_and_retry(monkeypatch):
    """Force the bucketed backend on at fixture scale (threshold -> 0)
    with a starvation-level starting cap: the pipeline's auto-retry must
    double its way to an exact grid — analyze() output bit-matches the
    brute-force run."""
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import sample_venue

    pts = sample_venue()
    base = Pipeline().analyze(pts)

    from lidar_crowd.config import MONOLITH_CONFIG
    monkeypatch.setattr(D, "BUCKETED_MIN_PAIRS", 0)
    pipe = Pipeline(MONOLITH_CONFIG.with_capacity(density_bucket_cap=2))
    out = pipe.analyze(pts)

    np.testing.assert_array_equal(out["density"]["density_grid"],
                                  base["density"]["density_grid"])
    assert out["density"]["total_people"] == base["density"]["total_people"]
    assert [h["density"] for h in out["density"]["hotspots"]] == \
        [h["density"] for h in base["density"]["hotspots"]]


@pytest.mark.parametrize("k,bucketed", [(63, False), (64, True),
                                        (65, True)])
def test_path_by_pair_count(monkeypatch, k, bucketed):
    """radius_count_grid takes the bucketed path exactly when cells x
    people capacity reaches BUCKETED_MIN_PAIRS (static sizes only), with
    the same counts either way."""
    gx, gy = 32, 32
    monkeypatch.setattr(D, "BUCKETED_MIN_PAIRS", gx * gy * 64)
    calls = []
    real = bd.radius_count_bucketed

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(bd, "radius_count_bucketed", spy)

    rng = np.random.RandomState(k)
    pos = rng.uniform(0, 32, (k, 2)).astype(np.float32)
    ppl = _people(pos, k - 3)
    origin = jnp.asarray(np.zeros(2, np.float32))
    counts, ov = D.radius_count_grid(ppl, origin, jnp.asarray(gx),
                                     jnp.asarray(gy), gx, gy, 1.0, 2.0,
                                     bucket_cap=64)
    assert bool(calls) == bucketed
    assert int(ov) == 0
    brute, _ = D.radius_count_grid(ppl, origin, jnp.asarray(gx),
                                   jnp.asarray(gy), gx, gy, 1.0, 2.0)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(brute))
