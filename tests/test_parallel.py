"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4(c)):
sharded results must match single-device results."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_crowd.config import MONOLITH_CONFIG
from lidar_crowd.models import flow as flow_mod
from lidar_crowd.models.train import TrainConfig
from lidar_crowd.parallel import spatial
from lidar_crowd.parallel.mesh import (
    make_mesh, spatial_mesh, train_mesh)
from lidar_crowd.parallel.trainer import (
    run_sharded_steps)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


TINY = TrainConfig(batch_size=4, n_points=256, grid=8, sa1_samples=64,
                   sa2_samples=16)


class TestShardedTraining:
    def test_dp_mp_step_runs(self):
        m = run_sharded_steps(TINY, train_mesh(8), n_steps=2)
        assert np.isfinite(m["loss"])

    def test_pure_dp_step_runs(self):
        cfg = TrainConfig(batch_size=8, n_points=256, grid=8,
                          sa1_samples=64, sa2_samples=16)
        m = run_sharded_steps(cfg, make_mesh((("dp", 8), ("mp", 1))),
                              n_steps=1)
        assert np.isfinite(m["loss"])

    def test_dp_matches_single_device(self):
        """Same batch, same init: dp-sharded step == unsharded step."""
        from lidar_crowd.models.train import (
            init_state, make_batch, train_step)
        from lidar_crowd.parallel.trainer import (
            make_sharded_train_step, sharded_init)

        cfg = TINY
        rng = np.random.RandomState(0)
        batch_np = make_batch(rng, cfg)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}

        s0 = init_state(cfg)
        s1, m1 = train_step(s0, batch, cfg)

        mesh = make_mesh((("dp", 4), ("mp", 2)))
        ss = sharded_init(cfg, mesh)
        step = make_sharded_train_step(cfg, mesh, ss)
        from jax.sharding import NamedSharding, PartitionSpec as P
        bsh = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
               for k, v in batch.items()}
        ss1, m2 = step(ss, bsh)
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4


class TestSpatialSharding:
    def test_sharded_density_matches(self, fixture_points, oracle_monolith):
        from lidar_crowd.models import (
            density as dm)
        from lidar_crowd.pipeline import Pipeline
        pipe = Pipeline(MONOLITH_CONFIG)
        cfg = pipe.fit_capacity(fixture_points)
        from lidar_crowd.types import PointCloud
        cloud = PointCloud.from_numpy(fixture_points,
                                      cfg.capacity.max_points)
        processed, people, res = pipe.analyze_device(cloud, cfg)

        mesh = spatial_mesh(8)
        grid_sharded = spatial.sharded_radius_density(
            people.positions, people.mask,
            jnp.stack([processed.mins[0], processed.mins[1]]),
            res.density.nx, res.density.ny, cfg, mesh)
        np.testing.assert_allclose(np.asarray(grid_sharded),
                                   np.asarray(res.density.density_grid),
                                   atol=1e-6)

    def test_sharded_flow_matches(self, fixture_points):
        from lidar_crowd.pipeline import Pipeline
        from lidar_crowd.types import PointCloud
        pipe = Pipeline(MONOLITH_CONFIG)
        cfg = pipe.fit_capacity(fixture_points)
        cloud = PointCloud.from_numpy(fixture_points,
                                      cfg.capacity.max_points)
        processed, people, res = pipe.analyze_device(cloud, cfg)
        u = jnp.asarray(flow_mod.bottleneck_uniforms(), jnp.float32)

        # single-device internals
        vec1, mag1, valid1, nx, ny = flow_mod.synthesize_flow(
            processed, u, cfg)
        sev1, ok1 = flow_mod._bottlenecks_monolith(mag1, valid1, cfg)

        mesh = spatial_mesh(8)
        vec2, mag2, valid2, sev2, ok2 = \
            spatial.sharded_flow_and_bottlenecks(
                processed.mins[:2], processed.maxs[:2], u, cfg, mesh)

        np.testing.assert_allclose(np.asarray(mag2),
                                   np.asarray(jnp.where(valid1, mag1,
                                                        0.0)), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(valid2),
                                      np.asarray(valid1))
        np.testing.assert_array_equal(
            np.asarray(ok2), np.asarray(ok1))
        # severities agree on accepted bottleneck nodes
        np.testing.assert_array_equal(
            np.asarray(sev2)[np.asarray(ok2)],
            np.asarray(sev1)[np.asarray(ok1)])


class TestHaloExchange:
    def test_halo_roundtrip(self):
        mesh = spatial_mesh(8)
        from jax.sharding import PartitionSpec as P
        x = jnp.arange(64.0).reshape(64, 1)

        def fn(local):
            return spatial.halo_exchange_x(local, 2, "sp")

        out = jax.shard_map(fn, mesh=mesh, in_specs=P("sp"),
                            out_specs=P("sp"))(x)
        out = np.asarray(out).reshape(8, 12)
        # shard 1 holds rows 8..15; its halo = rows 6,7 | 8..15 | 16,17
        np.testing.assert_allclose(out[1], [6, 7, 8, 9, 10, 11, 12, 13,
                                            14, 15, 16, 17])
        # boundary shards get zero halos
        np.testing.assert_allclose(out[0][:2], [0, 0])
        np.testing.assert_allclose(out[7][-2:], [0, 0])


class TestShardedDBSCAN:
    """Spatially-sharded DBSCAN (parallel/cluster.py): stripe partition +
    eps-halo + ppermute label exchange must reproduce single-device
    DBSCAN exactly (same min-gid representatives per component)."""

    def _venue(self, seed=3, n=1200):
        rng = np.random.RandomState(seed)
        centers = rng.uniform(-14, 14, (30, 2))
        pts = np.zeros((n, 3), np.float32)
        pts[:, :2] = centers[rng.randint(0, 30, n)] + rng.normal(
            0, 0.15, (n, 2))
        pts[:, 2] = rng.uniform(0, 1.8, n)
        return pts

    def test_matches_single_device(self):
        from sklearn.cluster import DBSCAN

        from lidar_crowd.parallel import (
            cluster as pc)
        from lidar_crowd.parallel.mesh import (
            make_mesh)

        pts = self._venue()
        eps, ms = 0.4, 5
        mesh = make_mesh((("sp", 8),))
        lab = pc.sharded_dbscan(pts, eps, ms, mesh)

        sk = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_
        # same noise set
        assert ((lab == -1) == (sk == -1)).all()
        # same partition: sharded labels are representative gids —
        # compare member-set censuses
        def census(labels):
            return sorted(
                tuple(sorted(np.nonzero(labels == c)[0].tolist()))
                for c in np.unique(labels[labels >= 0]))
        assert census(lab) == census(sk)

    def test_cross_boundary_component(self):
        """A single rope of points spanning every stripe boundary must
        come back as ONE cluster (worst case for halo exchange)."""
        from lidar_crowd.parallel import (
            cluster as pc)
        from lidar_crowd.parallel.mesh import (
            make_mesh)

        n = 400
        pts = np.zeros((n, 3), np.float32)
        pts[:, 0] = np.linspace(-16, 16, n)     # 0.08 m spacing < eps
        pts[:, 1] = 0.05 * np.sin(np.arange(n))
        mesh = make_mesh((("sp", 8),))
        lab = pc.sharded_dbscan(pts, 0.3, 3, mesh)
        assert (lab >= 0).all()
        assert len(np.unique(lab)) == 1

    def test_venue_scale_matches_single_device(self):
        """BASELINE config 5 at test scale: a >=200k-point venue sharded
        8 ways must bit-match the single-device column-grid DBSCAN
        (same dense labels once representatives are compacted)."""
        import jax.numpy as jnp

        from lidar_crowd.ops.clustering import (
            dbscan_labels)
        from lidar_crowd.parallel import (
            cluster as pc)
        from lidar_crowd.parallel.mesh import (
            make_mesh)
        from lidar_crowd.synthetic import (
            scaled_venue)

        pts = scaled_venue(200_000).astype(np.float32)
        eps, ms = 0.3, 5
        mesh = make_mesh((("sp", 8),))
        lab = pc.sharded_dbscan(pts, eps, ms, mesh)

        n = len(pts)
        single, n_clusters, overflow = dbscan_labels(
            jnp.asarray(pts), jnp.ones(n, bool), eps, ms,
            ncx=512, ncy=512, column_cap=32)
        single = np.asarray(single)
        assert int(overflow) == 0
        # sharded labels are representative gids ordered like the
        # single-device dense ids (both rank by min point index)
        reps = np.unique(lab[lab >= 0])
        dense = np.full(n + 1, -1, np.int64)
        dense[reps] = np.arange(len(reps))
        np.testing.assert_array_equal(
            np.where(lab >= 0, dense[np.clip(lab, 0, n)], -1), single)
        assert len(reps) == int(n_clusters)
