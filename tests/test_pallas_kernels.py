"""The plain jnp paths that replaced the former Pallas kernels, checked
against NumPy references: the density radius count, the set-abstraction
MLP + masked max-pool, and farthest-point sampling (single, batched and
vmapped)."""

import jax
import jax.numpy as jnp
import numpy as np

from lidar_crowd.models import density as dm
from lidar_crowd.ops.grouping import sa_mlp_pool
from lidar_crowd.ops.sampling import farthest_point_sampling
from lidar_crowd.types import People


def _radius_count_np(centers, people, pmask, radius):
    d2 = ((centers[:, None, :].astype(np.float32)
           - people[None, :, :].astype(np.float32)) ** 2).sum(-1)
    return ((d2 <= np.float32(radius) ** 2) & pmask[None, :]).sum(1)


def _fps_np(points, mask, n_samples, start=0):
    """Brute-force FPS: the first max of the running min-distance."""
    pts = points.astype(np.float32)
    dist = np.full(len(pts), np.finfo(np.float32).max, np.float32)
    out = [start]
    for _ in range(1, n_samples):
        d = ((pts - pts[out[-1]]) ** 2).sum(1)
        dist = np.minimum(dist, d)
        out.append(int(np.argmax(np.where(mask, dist, -np.inf))))
    return np.asarray(out, np.int32)


def _sa_np(grouped, valid, weights):
    x = grouped.astype(np.float64)
    for w, b in weights:
        x = np.maximum(x @ np.asarray(w, np.float64) + np.asarray(b), 0.0)
    x = np.where(valid[..., None], x, -1e9)
    return np.where(valid.any(1)[:, None], x.max(1), 0.0)


class TestRadiusCount:
    def test_matches_reference(self):
        rng = np.random.RandomState(0)
        gx, gy, k = 24, 30, 300
        people = rng.uniform(0, 25, (k, 2)).astype(np.float32)
        pmask = np.arange(k) < 250
        origin = np.asarray([0.0, 0.0], np.float32)
        counts, overflow = dm.radius_count_grid(
            People(positions=jnp.asarray(people), mask=jnp.asarray(pmask),
                   z=jnp.zeros(k)),
            jnp.asarray(origin), jnp.asarray(gx), jnp.asarray(gy), gx, gy,
            1.0, 2.0, chunk=128)
        ci, cj = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
        centers = np.stack([(ci + 0.5).ravel(), (cj + 0.5).ravel()], 1)
        want = _radius_count_np(centers, people, pmask, 2.0)
        np.testing.assert_array_equal(np.asarray(counts).ravel(), want)
        assert int(overflow) == 0

    def test_empty_people(self):
        k = 8
        counts, _ = dm.radius_count_grid(
            People(positions=jnp.zeros((k, 2)), mask=jnp.zeros(k, bool),
                   z=jnp.zeros(k)),
            jnp.zeros(2), jnp.asarray(4), jnp.asarray(4), 4, 4, 1.0, 1.0)
        assert np.asarray(counts).sum() == 0


class TestSAMLPPool:
    def test_matches_reference(self):
        rng = np.random.RandomState(1)
        m, k, cin = 100, 16, 6
        grouped = rng.randn(m, k, cin).astype(np.float32)
        valid = rng.rand(m, k) > 0.3
        dims = [cin, 16, 16, 32]
        weights = [(rng.randn(a, b).astype(np.float32) * 0.2,
                    rng.randn(b).astype(np.float32) * 0.1)
                   for a, b in zip(dims[:-1], dims[1:])]
        with jax.default_matmul_precision("highest"):
            got = sa_mlp_pool(jnp.asarray(grouped), jnp.asarray(valid),
                              [(jnp.asarray(w), jnp.asarray(b))
                               for w, b in weights])
        np.testing.assert_allclose(np.asarray(got),
                                   _sa_np(grouped, valid, weights),
                                   atol=1e-4)
        # bf16 operands, f32 accumulation: within bf16 rounding
        bf = sa_mlp_pool(jnp.asarray(grouped), jnp.asarray(valid),
                         [(jnp.asarray(w), jnp.asarray(b))
                          for w, b in weights], compute_dtype=jnp.bfloat16)
        np.testing.assert_allclose(np.asarray(bf), np.asarray(got),
                                   atol=0.05 * float(np.abs(got).max()))

    def test_empty_neighborhood_zeroed(self):
        m, k, cin = 8, 4, 3
        grouped = jnp.ones((m, k, cin), jnp.float32)
        valid = jnp.zeros((m, k), bool).at[0].set(True)
        weights = [(jnp.eye(3, 8, dtype=jnp.float32),
                    jnp.zeros(8, jnp.float32)),
                   (jnp.eye(8, 8, dtype=jnp.float32),
                    jnp.zeros(8, jnp.float32)),
                   (jnp.eye(8, 8, dtype=jnp.float32),
                    jnp.zeros(8, jnp.float32))]
        got = np.asarray(sa_mlp_pool(grouped, valid, weights))
        assert np.all(got[1:] == 0.0)
        assert np.any(got[0] != 0.0)


class TestFPS:
    def test_matches_jnp_fps(self):
        rng = np.random.RandomState(2)
        pts = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
        mask = np.arange(256) < 200
        got = np.asarray(farthest_point_sampling(
            jnp.asarray(pts), jnp.asarray(mask), 32))
        np.testing.assert_array_equal(got, _fps_np(pts, mask, 32))

    def test_spreads_over_cloud(self):
        # FPS on a line must pick the two endpoints early
        pts = jnp.asarray(
            np.stack([np.linspace(0, 10, 128),
                      np.zeros(128), np.zeros(128)], 1), jnp.float32)
        mask = jnp.ones(128, bool)
        sel = np.asarray(farthest_point_sampling(pts, mask, 4))
        assert 0 in sel and 127 in sel

    def test_batched_and_vmap_match_single(self):
        # the batched form CrowdNet's lifted vmap takes must select
        # exactly what the brute-force reference selects per example
        rng = np.random.RandomState(3)
        pts = rng.uniform(-5, 5, (4, 300, 3)).astype(np.float32)
        mask = rng.rand(4, 300) > 0.15
        want = np.stack([_fps_np(pts[i], mask[i], 24) for i in range(4)])
        vmapped = np.asarray(jax.jit(jax.vmap(
            lambda p, m: farthest_point_sampling(p, m, 24)))(
                jnp.asarray(pts), jnp.asarray(mask)))
        np.testing.assert_array_equal(vmapped, want)
