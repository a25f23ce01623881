"""Hash-grid neighbor search vs brute-force NumPy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from lidar_crowd.ops import hashgrid


def _random_cloud(n, cap, d=3, seed=0, scale=5.0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-scale, scale, (n, d)).astype(np.float32)
    buf = np.zeros((cap, d), np.float32)
    buf[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pts, jnp.asarray(buf), jnp.asarray(mask)


@pytest.mark.parametrize("n,cap,radius", [(500, 512, 0.8), (1000, 1024, 0.3),
                                          (77, 128, 2.0)])
def test_ball_count_matches_bruteforce(n, cap, radius):
    pts, P, M = _random_cloud(n, cap)
    grid = hashgrid.build_grid(P, M, radius)
    counts = np.asarray(hashgrid.ball_count(grid, P, M, radius,
                                            bucket_capacity=64))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    expected = (d2 <= radius * radius).sum(1)
    np.testing.assert_array_equal(counts[:n], expected)
    np.testing.assert_array_equal(counts[n:], 0)


def test_ball_query_returns_exact_neighbor_sets():
    n, cap, radius = 400, 512, 1.0
    pts, P, M = _random_cloud(n, cap, seed=3)
    grid = hashgrid.build_grid(P, M, radius)
    idx, ok = hashgrid.ball_query(grid, P, M, radius, k=64,
                                  bucket_capacity=64)
    idx, ok = np.asarray(idx), np.asarray(ok)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    for i in range(0, n, 17):
        expected = set(np.where(d2[i] <= radius * radius)[0])
        got = set(idx[i][ok[i]])
        assert got == expected


def test_ball_query_2d():
    n, cap, radius = 300, 512, 1.5
    rng = np.random.RandomState(7)
    pts = rng.uniform(-10, 10, (n, 2)).astype(np.float32)
    buf = np.zeros((cap, 2), np.float32)
    buf[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    grid = hashgrid.build_grid(jnp.asarray(buf), jnp.asarray(mask), radius)
    counts = np.asarray(hashgrid.ball_count(grid, jnp.asarray(buf),
                                            jnp.asarray(mask), radius,
                                            bucket_capacity=64))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(counts[:n],
                                  (d2 <= radius * radius).sum(1))


def test_masked_points_excluded():
    pts, P, M = _random_cloud(100, 256, seed=5)
    # invalidate half
    M = M.at[50:].set(False)
    grid = hashgrid.build_grid(P, M, 1.0)
    counts = np.asarray(hashgrid.ball_count(grid, P, M, 1.0))
    d2 = ((pts[:50, None, :] - pts[None, :50, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(counts[:50], (d2 <= 1.0).sum(1))
    np.testing.assert_array_equal(counts[50:], 0)
