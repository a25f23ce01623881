"""Unit tests for ops/sampling (FPS is covered via CrowdNet/test_pallas;
these pin the two downsamplers the product surface reaches through
`lidar-crowd analyze --downsample/--voxel` and the overflow advice in
pipeline._OVERFLOW_MSG)."""

import jax
import jax.numpy as jnp
import numpy as np

from lidar_crowd.ops.sampling import (
    random_downsample, voxel_downsample)


def test_random_downsample_fraction_and_mask():
    n = 10_000
    pts = jnp.asarray(np.random.RandomState(0).rand(n, 3), jnp.float32)
    mask = jnp.arange(n) < 8000
    _, keep = random_downsample(jax.random.PRNGKey(0), pts, mask, 0.25)
    kept = int(keep.sum())
    assert 0.2 * 8000 < kept < 0.3 * 8000
    assert not bool((keep & ~mask).any())  # never resurrects padding
    # factor >= 1: identity
    _, keep1 = random_downsample(jax.random.PRNGKey(0), pts, mask, 1.0)
    assert bool((keep1 == mask).all())


def test_random_downsample_keeps_at_least_one():
    pts = jnp.zeros((64, 3), jnp.float32)
    mask = jnp.zeros(64, bool).at[13].set(True)
    _, keep = random_downsample(jax.random.PRNGKey(3), pts, mask, 1e-6)
    assert int(keep.sum()) == 1 and bool(keep[13])


def test_voxel_downsample_one_per_voxel_lowest_index():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-50, 50, (5000, 3)).astype(np.float32)
    mask = np.ones(5000, bool)
    mask[4000:] = False
    _, keep = voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.7)
    keep = np.asarray(keep)
    assert not (keep & ~mask).any()

    # NumPy oracle: first valid index per voxel
    pmin = pts[mask].min(axis=0)
    coords = np.floor((pts - pmin) / 0.7).astype(np.int64)
    seen = {}
    for i in range(4000):
        seen.setdefault(tuple(coords[i]), i)
    expected = np.zeros(5000, bool)
    expected[list(seen.values())] = True
    np.testing.assert_array_equal(keep, expected)


def test_voxel_downsample_no_overflow_at_venue_scale():
    """Centimetre voxels over a 400 m venue: the flattened-id
    formulation overflowed int32 here; the 3-key sort must not."""
    rng = np.random.RandomState(2)
    pts = rng.uniform(-200, 200, (2000, 3)).astype(np.float32)
    _, keep = voxel_downsample(jnp.asarray(pts),
                               jnp.ones(2000, bool), 0.01)
    # 2000 random points over (400 m)^3 at 1 cm: collisions ~impossible
    assert int(np.asarray(keep).sum()) == 2000
