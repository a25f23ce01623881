"""DBSCAN-equivalence: our hash-grid label propagation must reproduce
sklearn's cluster census (SURVEY.md §7 hard part (a))."""

import jax.numpy as jnp
import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from lidar_crowd.ops import clustering


def _census(labels, pts):
    """Canonical cluster census: sorted list of sorted member-index
    tuples restricted to core-agnostic exact comparison via centroids."""
    cents = []
    for c in np.unique(labels[labels >= 0]):
        cents.append(tuple(np.round(pts[labels == c].mean(0), 5)))
    return sorted(cents)


def _run_ours(pts, eps, min_samples, cap=None):
    n = len(pts)
    cap = cap or 1 << (n - 1).bit_length()
    buf = np.zeros((cap, pts.shape[1]), np.float32)
    buf[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    labels, ncl, overflow = clustering.dbscan_labels(
        jnp.asarray(buf), jnp.asarray(mask), eps, min_samples,
        ncx=128, ncy=128, column_cap=128)
    assert int(overflow) == 0
    return np.asarray(labels)[:n], int(ncl)


@pytest.mark.parametrize("seed,n,eps,ms", [(0, 800, 0.4, 5), (1, 500, 0.6, 4),
                                           (2, 1200, 0.3, 3)])
def test_dbscan_census_random(seed, n, eps, ms):
    rng = np.random.RandomState(seed)
    # mix of clusters and background noise
    centers = rng.uniform(-8, 8, (12, 3))
    cluster_pts = (centers[rng.randint(0, 12, n // 2)]
                   + rng.normal(0, 0.15, (n // 2, 3)))
    noise = rng.uniform(-10, 10, (n - n // 2, 3))
    pts = np.vstack([cluster_pts, noise]).astype(np.float32)

    sk = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_
    ours, ncl = _run_ours(pts, eps, ms)

    assert ncl == sk.max() + 1
    # noise sets can differ only in border assignment; core census must match
    assert _census(ours, pts) == _census(sk, pts)


def test_dbscan_fixture_census(fixture_points, oracle_monolith):
    pro = oracle_monolith["processed"]
    ng = pro["points"][~pro["ground_mask"]].astype(np.float32)
    sk = DBSCAN(eps=0.3, min_samples=5).fit(ng).labels_
    ours, ncl = _run_ours(ng, 0.3, 5, cap=8192)
    assert ncl == sk.max() + 1 == 446
    assert (ours == -1).sum() == (sk == -1).sum()
    assert _census(ours, ng) == _census(sk, ng)


def test_dbscan_columns_matches_bruteforce():
    """The venue-scale column-grid path must agree with the exact
    all-pairs path (and sklearn) on a spread-out venue."""
    import jax.numpy as jnp
    rng = np.random.RandomState(11)
    centers = rng.uniform(-25, 25, (150, 2))
    n = 3000
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = centers[rng.randint(0, 150, n)] + rng.normal(0, 0.12,
                                                              (n, 2))
    pts[:, 2] = rng.uniform(0, 1.8, n)
    cap = 4096
    buf = np.zeros((cap, 3), np.float32)
    buf[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    sk = DBSCAN(eps=0.35, min_samples=5).fit(pts).labels_
    lab_c, ncl_c, ovf = clustering.dbscan_columns(
        jnp.asarray(buf), jnp.asarray(mask), 0.35, 5,
        ncx=128, ncy=128, column_cap=64)
    assert int(ovf) == 0
    lab_c = np.asarray(lab_c)[:n]
    assert int(ncl_c) == sk.max() + 1
    assert _census(lab_c, pts) == _census(sk, pts)


def test_cluster_centroids_segment_mean():
    pts = jnp.asarray(np.array([[0, 0, 0], [2, 0, 0], [0, 4, 0], [9, 9, 9]],
                               np.float32))
    labels = jnp.asarray(np.array([0, 0, 1, -1], np.int32))
    cents, valid, overflow = clustering.cluster_centroids(pts, labels, 4)
    cents, valid = np.asarray(cents), np.asarray(valid)
    assert valid.tolist() == [True, True, False, False]
    assert int(overflow) == 0
    np.testing.assert_allclose(cents[0], [1, 0, 0])
    np.testing.assert_allclose(cents[1], [0, 4, 0])


def test_cluster_centroids_overflow_count():
    """Cluster ids >= capacity are counted, not silently dropped."""
    pts = jnp.asarray(np.arange(18, dtype=np.float32).reshape(6, 3))
    labels = jnp.asarray(np.array([0, 1, 2, 3, 4, 5], np.int32))
    cents, valid, overflow = clustering.cluster_centroids(pts, labels, 4)
    assert int(overflow) == 2  # ids 4 and 5 spill past capacity 4
    assert np.asarray(valid).sum() == 4


def _modular_scale(pts):
    """The modular variant's StandardScaler warp (preprocess.py:115-126):
    per-axis masked standardisation of the clustering inputs."""
    mu = pts.mean(axis=0)
    sd = np.maximum(pts.std(axis=0), 1e-12)
    return ((pts - mu) / sd).astype(np.float32)


def _blob_venue(n, n_blobs, extent, z_max, seed, blob_sigma=0.35):
    """Crowd blobs + sparse walk-space noise with a SQUASHED raw z
    (z in [0, z_max] << xy extent), so the modular standardisation
    stretches z hard relative to xy — the scaled-space geometry the
    10k-point modular parity fixtures never reach."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-extent, extent, (n_blobs, 2))
    nb = int(n * 0.8)
    pts = np.zeros((n, 3), np.float32)
    which = rng.randint(0, n_blobs, nb)
    pts[:nb, :2] = centers[which] + rng.normal(0, blob_sigma, (nb, 2))
    pts[nb:, :2] = rng.uniform(-extent, extent, (n - nb, 2))
    pts[:, 2] = rng.uniform(0, z_max, n)
    return pts


def test_modular_scaled_space_census_vs_sklearn():
    """Venue-scale modular parity against sklearn in the SAME scaled
    space. Standardisation makes eps = 0.5 MACROSCOPIC (the venue spans
    ~7 eps per axis), so eps-column decomposition degenerates; above
    32k the modular variant routes through the packed brute force
    (brute_cap=BRUTEFORCE_HARD_CAP) — the geometry the 10k-point modular
    parity fixtures never reach."""
    import jax.numpy as jnp
    n = 60_000
    pts = _blob_venue(n, n_blobs=36, extent=120.0, z_max=0.4, seed=5)
    scaled = _modular_scale(pts)
    eps, ms = 0.5, 5  # the modular adaptive eps (preprocess.py:124-125)

    sk = DBSCAN(eps=eps, min_samples=ms).fit(scaled).labels_

    cap = 65536
    buf = np.zeros((cap, 3), np.float32)
    buf[:n] = scaled
    mask = np.zeros(cap, bool)
    mask[:n] = True
    labels, ncl, overflow = clustering.dbscan_labels(
        jnp.asarray(buf), jnp.asarray(mask), eps, ms,
        brute_cap=clustering.BRUTEFORCE_HARD_CAP)
    assert int(overflow) == 0
    ours = np.asarray(labels)[:n]

    assert int(ncl) == sk.max() + 1
    assert _census(ours, scaled) == _census(sk, scaled)


def test_modular_pipeline_venue_scale_census():
    """End-to-end: the modular Pipeline at >32k points (the capacity
    band that used to route warped space through eps-columns and
    silently drop ~95% of points as column overflow) must reproduce
    the CPU reference oracle's census."""
    from lidar_crowd.config import MODULAR_CONFIG
    from lidar_crowd.oracle import (
        reference as ref)
    from lidar_crowd.pipeline import Pipeline

    n = 48_000
    pts = _blob_venue(n, n_blobs=24, extent=90.0, z_max=0.6, seed=7
                      ).astype(np.float64)
    out = Pipeline(MODULAR_CONFIG).analyze(pts)
    oracle = ref.preprocess(pts, variant="modular")
    n_ref = oracle["clusters"].max() + 1

    proc = out["processed"]
    inlier = np.asarray(proc.mask)[:n]
    ours = np.asarray(proc.labels)[:n][inlier]
    opts = oracle["points"]

    assert int(out["density"]["total_people"]) == n_ref
    assert _census(ours, pts[inlier]) == _census(oracle["clusters"], opts)


def test_modular_overflow_ceiling_raises(monkeypatch):
    """Past the brute-force HBM wall the pipeline must refuse loudly,
    not return a silently-wrong census (reference counterpart: sklearn
    MemoryError, utils/data_processing.py:197). Exercised by shrinking
    the wall rather than allocating 131k^2 bits."""
    from lidar_crowd.config import MODULAR_CONFIG
    from lidar_crowd.pipeline import Pipeline

    monkeypatch.setattr(clustering, "BRUTEFORCE_HARD_CAP", 1024)
    pts = _blob_venue(6_000, n_blobs=12, extent=60.0, z_max=0.5, seed=9
                      ).astype(np.float64)
    pipe = Pipeline(MODULAR_CONFIG.with_capacity(cluster_column_cap=512))
    with pytest.raises(RuntimeError, match="brute force"):
        pipe.analyze(pts)


def test_centroids_sorted_no_phantom_slots():
    """The sort+scan centroid path must leave slots past the dense
    cluster count EXACTLY zero (a packing that left partial prefix rows
    there would report phantom people), and agree with a segment_sum
    scatter-add on the real slots."""
    import jax

    rng = np.random.RandomState(7)
    n, n_clusters, k = 20_000, 153, 256
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    labels = rng.randint(-1, n_clusters, n).astype(np.int32)
    seg = jnp.where(jnp.asarray(labels) >= 0, jnp.asarray(labels), k)

    sums, cnts = clustering._centroids_sorted(
        jnp.asarray(pts), seg.astype(jnp.int32), k)
    sums, cnts = np.asarray(sums), np.asarray(cnts)

    assert cnts[n_clusters:].sum() == 0
    assert np.abs(sums[n_clusters:]).sum() == 0

    ref_s = jax.ops.segment_sum(jnp.asarray(pts), seg,
                                num_segments=k + 1)[:k]
    ref_c = jax.ops.segment_sum(jnp.ones(n, jnp.float32), seg,
                                num_segments=k + 1)[:k]
    np.testing.assert_array_equal(cnts, np.asarray(ref_c))
    np.testing.assert_allclose(sums, np.asarray(ref_s), atol=2e-3)


def test_lane_prefix_df_matches_float64_cumsum():
    """The lane-parallel compensated prefix must track the float64
    cumsum to double-float accuracy (~2^-40 relative at 200k rows,
    far beyond plain f32's ~1e-3 drift there)."""
    from lidar_crowd.ops import clustering as cl

    rng = np.random.RandomState(11)
    n = 200_000
    v = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    hi, lo = cl._lane_prefix_df(jnp.asarray(v))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = np.cumsum(v.astype(np.float64), axis=0)
    err = np.abs(got - want).max()
    assert err < 1e-2, err            # plain f32 cumsum: ~0.5 here
    # and the compensated pair is much tighter than hi alone
    assert err < np.abs(np.asarray(hi, np.float64) - want).max() + 1e-9


@pytest.mark.parametrize("capacity,path", [(2016, "bruteforce"),
                                           (2048, "bruteforce"),
                                           (2080, "columns")])
def test_dbscan_path_by_capacity(monkeypatch, capacity, path):
    """dbscan_labels picks its path from the static capacity alone —
    all-pairs up to BRUTEFORCE_MAX_POINTS, column grid above — and both
    paths give the same labels on the same points."""
    monkeypatch.setattr(clustering, "BRUTEFORCE_MAX_POINTS", 2048)
    taken = []
    for name in ("dbscan_bruteforce", "dbscan_columns"):
        real = getattr(clustering, name)

        def spy(*a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(clustering, name, spy)

    rng = np.random.RandomState(4)
    n = 1500
    centers = rng.uniform(-10, 10, (40, 2))
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = centers[rng.randint(0, 40, n)] + rng.normal(0, 0.12,
                                                             (n, 2))
    pts[:, 2] = rng.uniform(0, 1.8, n)

    def run(cap):
        buf = np.zeros((cap, 3), np.float32)
        buf[:n] = pts
        labels, ncl, overflow = clustering.dbscan_labels(
            jnp.asarray(buf), jnp.asarray(np.arange(cap) < n), 0.35, 5,
            ncx=64, ncy=64, column_cap=64)
        assert int(overflow) == 0
        return np.asarray(labels)[:n], int(ncl)

    labels, ncl = run(capacity)
    assert taken == ["dbscan_" + path]

    sk = DBSCAN(eps=0.35, min_samples=5).fit(pts).labels_
    assert ncl == sk.max() + 1
    assert _census(labels, pts) == _census(sk, pts)
    ref, _ = run(4096)    # column path
    np.testing.assert_array_equal(labels, ref)


@pytest.mark.parametrize("n,n_clusters,k", [(1000, 1, 8),
                                            (50_000, 3_000, 4_096),
                                            (300_000, 40_000, 40_000)])
def test_cluster_centroids_match_float64(n, n_clusters, k):
    """cluster_centroids (one path at every size) equals NumPy float64
    segment means to within a few f32 ulps, counts exactly, and gives the
    same bits on a second run."""
    rng = np.random.RandomState(n)
    pts = rng.uniform(-500, 500, (n, 3)).astype(np.float32)
    labels = np.concatenate([np.arange(n_clusters),
                             rng.randint(-1, n_clusters, n - n_clusters)])
    labels = labels[rng.permutation(n)].astype(np.int32)
    cents, valid, overflow = clustering.cluster_centroids(
        jnp.asarray(pts), jnp.asarray(labels), k)
    again = clustering.cluster_centroids(
        jnp.asarray(pts), jnp.asarray(labels), k)[0]

    ok = labels >= 0
    cnt = np.bincount(labels[ok], minlength=k)
    want = np.stack([np.bincount(labels[ok], pts[ok, i].astype(np.float64),
                                 minlength=k) for i in range(3)], 1)
    want /= np.maximum(cnt, 1)[:, None]
    live = cnt > 0
    assert int(overflow) == 0
    np.testing.assert_array_equal(np.asarray(valid), live)
    # 500 m coordinates: one f32 ulp is 3.1e-5 m
    np.testing.assert_allclose(np.asarray(cents)[live], want[live],
                               rtol=0, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(cents), np.asarray(again))
