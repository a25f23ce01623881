"""Ball-query grouping: first-K-in-scan-order parity with a NumPy oracle
(the classic CUDA ball-query semantics PointNet++ assumes)."""

import jax.numpy as jnp
import numpy as np

from lidar_crowd.ops.grouping import (
    ball_group, group_features)


def test_ball_group_first_k_scan_order():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    q = pts[:128]
    k, r = 16, 0.8
    idx, val = ball_group(jnp.asarray(q), jnp.ones(128, bool),
                          jnp.asarray(pts), jnp.ones(3000, bool), r, k)
    idx, val = np.asarray(idx), np.asarray(val)
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    for i in range(128):
        hits = np.nonzero(d2[i] <= r * r)[0][:k]
        assert val[i].sum() == len(hits)
        assert (idx[i][val[i]] == hits).all()
        # padding repeats the first neighbor
        if 0 < len(hits) < k:
            assert (idx[i][~val[i]] == hits[0]).all()


def test_ball_group_masks_and_empty():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    pmask = np.arange(500) < 400
    q = np.array([[0.0, 0.0, 0.0], [100.0, 100.0, 100.0]], np.float32)
    idx, val = ball_group(jnp.asarray(q), jnp.ones(2, bool),
                          jnp.asarray(pts), jnp.asarray(pmask), 1.0, 8)
    idx, val = np.asarray(idx), np.asarray(val)
    assert (idx[0][val[0]] < 400).all()          # masked points excluded
    assert not val[1].any()                      # empty neighborhood

    g = group_features(jnp.asarray(pts), None, jnp.asarray(q),
                       jnp.asarray(idx), jnp.asarray(val))
    assert np.asarray(g)[1].sum() == 0.0         # invalid slots zeroed


def test_ball_group_hashgrid_backend_matches_dense():
    """The hashgrid backend (the large-N path, past
    BRUTEFORCE_MAX_SOURCE sources) must return the SAME neighbor SET as
    the dense path wherever a neighborhood fits in K, and the same
    neighbor count (capped at K) everywhere."""
    rng = np.random.RandomState(7)
    pts = rng.uniform(-20, 20, (20000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05                       # venue-like 2.5D slab
    q = pts[rng.choice(20000, 256, replace=False)]
    qm = jnp.ones(256, bool)
    pm = jnp.ones(20000, bool)
    k, r = 24, 0.8
    i_d, v_d = ball_group(jnp.asarray(q), qm, jnp.asarray(pts), pm, r, k,
                          method="dense")
    i_h, v_h = ball_group(jnp.asarray(q), qm, jnp.asarray(pts), pm, r, k,
                          method="hashgrid")
    i_d, v_d = np.asarray(i_d), np.asarray(v_d)
    i_h, v_h = np.asarray(i_h), np.asarray(v_h)
    np.testing.assert_array_equal(v_d.sum(1), v_h.sum(1))
    for i in range(256):
        if v_d[i].sum() < k:                # full neighborhood captured
            assert set(i_d[i][v_d[i]]) == set(i_h[i][v_h[i]])
        else:                               # any-K-subset: all in radius
            d2 = ((q[i] - pts[i_h[i][v_h[i]]]) ** 2).sum(-1)
            assert (d2 <= r * r + 1e-5).all()
