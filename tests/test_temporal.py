"""Temporal flow: tracking + field estimation."""

import jax.numpy as jnp
import numpy as np

from lidar_crowd.config import MONOLITH_CONFIG
from lidar_crowd.models import temporal
from lidar_crowd.types import People


def _people(xy, cap=64, z=1.0):
    buf = np.zeros((cap, 2), np.float32)
    buf[:len(xy)] = xy
    m = np.zeros(cap, bool)
    m[:len(xy)] = True
    zz = np.full(cap, z, np.float32)
    return People(positions=jnp.asarray(buf), mask=jnp.asarray(m),
                  z=jnp.asarray(zz))


def test_matching_recovers_known_motion():
    rng = np.random.RandomState(0)
    prev_xy = rng.uniform(-10, 10, (20, 2))
    vel = np.array([1.0, 0.5])
    curr_xy = prev_xy + vel * 0.5  # dt = 0.5 s
    prev, curr = _people(prev_xy), _people(curr_xy)
    v, ok = temporal.frame_velocities(prev, curr, dt=0.5)
    v, ok = np.asarray(v), np.asarray(ok)
    assert ok[:20].all() and not ok[20:].any()
    np.testing.assert_allclose(v[:20], np.tile(vel, (20, 1)), atol=1e-5)


def test_matching_rejects_teleports():
    prev = _people(np.array([[0.0, 0.0]]))
    curr = _people(np.array([[50.0, 50.0]]))  # impossible jump
    _, ok = temporal.frame_velocities(prev, curr, dt=0.1)
    assert not np.asarray(ok).any()


def test_temporal_flow_field():
    # well-separated crowd (spacing >> per-frame displacement, the NN
    # tracking regime): 5x6 lattice with jitter, everyone moving +x
    rng = np.random.RandomState(1)
    gx, gy = np.meshgrid(np.linspace(-10, 10, 6), np.linspace(-8, 8, 5))
    prev_xy = (np.stack([gx.ravel(), gy.ravel()], 1)
               + rng.uniform(-0.4, 0.4, (30, 2)))
    curr_xy = prev_xy + np.array([0.6, 0.0])
    cap = MONOLITH_CONFIG.capacity.max_people
    prev, curr = _people(prev_xy, cap), _people(curr_xy, cap)
    res = temporal.temporal_flow(
        prev, curr, 1.0,
        jnp.asarray([-12.0, -12.0], jnp.float32),
        jnp.asarray([12.0, 12.0], jnp.float32), MONOLITH_CONFIG)
    d = res.to_host_dict()
    assert d["dominant_direction"] == "E"
    assert abs(d["avg_speed"] - 0.6) < 1e-4
    # all measured vectors point +x
    vec = d["flow_vectors"]["vectors"]
    assert len(vec) > 0
    np.testing.assert_allclose(vec[:, 1], 0.0, atol=1e-5)
    assert (vec[:, 0] > 0).all()


def test_multi_frame_averages_all_pairs():
    """temporal_flow_multi must use every consecutive pair: with noisy
    per-pair displacements around a constant drift, the multi-frame
    average is closer to truth than the worst single pair."""
    rng = np.random.RandomState(2)
    gx, gy = np.meshgrid(np.linspace(-10, 10, 6), np.linspace(-8, 8, 5))
    base = (np.stack([gx.ravel(), gy.ravel()], 1)
            + rng.uniform(-0.4, 0.4, (30, 2)))
    drift = np.array([0.5, 0.0])
    cap = MONOLITH_CONFIG.capacity.max_people
    frames_xy = []
    pos = base.copy()
    for t in range(5):
        frames_xy.append(pos.copy())
        pos = pos + drift + rng.normal(0, 0.1, (30, 2))  # noisy steps
    seq = [ _people(xy, cap) for xy in frames_xy ]
    import jax
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *seq)
    mins = jnp.asarray([-14.0, -12.0], jnp.float32)
    maxs = jnp.asarray([16.0, 12.0], jnp.float32)
    multi = temporal.temporal_flow_multi(
        stacked, 1.0, mins, maxs, MONOLITH_CONFIG).to_host_dict()
    assert multi["dominant_direction"] == "E"
    # averaging 4 pairs: mean speed within the noise-reduced band
    assert abs(multi["avg_speed"] - 0.5) < 0.1
    # two-frame wrapper == multi on the same two frames
    two = temporal.temporal_flow(
        seq[0], seq[1], 1.0, mins, maxs, MONOLITH_CONFIG).to_host_dict()
    pair = temporal.temporal_flow_multi(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), seq[0], seq[1]),
        1.0, mins, maxs, MONOLITH_CONFIG).to_host_dict()
    np.testing.assert_allclose(two["flow_vectors"]["vectors"],
                               pair["flow_vectors"]["vectors"])


def _run_multi(frames_xy, masks=None, cap=64, dt=1.0, lo=-14.0, hi=14.0):
    import jax
    seq = []
    for t, xy in enumerate(frames_xy):
        p = _people(xy, cap)
        if masks is not None:
            m = np.zeros(cap, bool)
            m[:len(xy)] = masks[t]
            p = People(positions=p.positions, mask=jnp.asarray(m), z=p.z)
        seq.append(p)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *seq)
    return temporal.temporal_flow_multi(
        stacked, dt, jnp.asarray([lo, lo], jnp.float32),
        jnp.asarray([hi, hi], jnp.float32), MONOLITH_CONFIG).to_host_dict()


def test_crossing_pedestrian_lanes():
    """Two opposing lanes 0.6 m apart (closer than the 1 m per-frame
    displacement, so raw NN matches cross lanes): the consistency filter
    must keep only samples that agree with the true lane velocity, never
    blended/reversed identity-swap artifacts."""
    n_lane = 8
    xs = np.linspace(-10, 4, n_lane)
    frames = []
    for t in range(6):
        a = np.stack([xs + 1.0 * t, np.full(n_lane, +0.3)], 1)   # +x lane
        b = np.stack([-xs - 1.0 * t, np.full(n_lane, -0.3)], 1)  # -x lane
        frames.append(np.concatenate([a, b]))
    d = _run_multi(frames)
    vec = d["flow_vectors"]["vectors"]
    mag = np.linalg.norm(vec, axis=1)
    live = mag > 0.05
    assert live.any()
    # every surviving node vector is a clean lane velocity: |vx| ~ 1,
    # vy ~ 0 (swaps between opposing lanes would leave vy or reversed
    # blends of magnitude << 1)
    assert np.all(np.abs(np.abs(vec[live, 0]) - 1.0) < 0.15), vec[live]
    assert np.all(np.abs(vec[live, 1]) < 0.15)
    # cosine vs the lane truth at each node (sign of y picks the lane);
    # the y=0 node row sits 0.3 m from BOTH lanes and legitimately
    # carries either sign, so only unambiguous rows are scored
    pos = d["flow_vectors"]["positions"][live]
    sided = np.abs(pos[:, 1]) >= 0.5
    assert sided.any()
    truth = np.stack([np.where(pos[sided, 1] > 0, 1.0, -1.0),
                      np.zeros(int(sided.sum()))], 1)
    unit = vec[live][sided] / mag[live][sided, None]
    cos = np.mean(np.sum(unit * truth, axis=1))
    assert cos > 0.95, cos


def test_entry_exit_mid_sequence():
    """People entering or leaving between frames must contribute no
    spurious velocity samples (an entrant has no previous identity; a
    leaver has no current one)."""
    rng = np.random.RandomState(3)
    base = rng.uniform(-8, 8, (12, 2))
    vel = np.array([0.7, 0.0])
    frames, masks = [], []
    for t in range(5):
        frames.append(base + vel * t)
        m = np.ones(12, bool)
        if t >= 2:
            m[0] = False           # person 0 exits after frame 1
        if t < 3:
            m[11] = False          # person 11 enters at frame 3
        masks.append(m)
    d = _run_multi(frames, masks)
    vec = d["flow_vectors"]["vectors"]
    mag = np.linalg.norm(vec, axis=1)
    live = mag > 0.05
    assert live.any()
    np.testing.assert_allclose(vec[live, 0], 0.7, atol=0.1)
    np.testing.assert_allclose(vec[live, 1], 0.0, atol=0.1)
    assert d["dominant_direction"] == "E"


def test_merge_split_event():
    """Two people walking toward each other merge into one cluster for a
    frame, then split. The merge/split identity jumps inject O(1 m/s)
    outliers the consistency filter must reject — surviving node speeds
    stay at the true 0.4 m/s scale."""
    # P walks +y at 0.4, Q walks -y at 0.4; they coincide at t=2 (merged:
    # one centroid) and separate again. A static far-away crowd keeps the
    # field populated.
    rng = np.random.RandomState(4)
    bg = rng.uniform(5, 12, (6, 2))
    frames, masks = [], []
    for t in range(5):
        py = -0.8 + 0.4 * t
        qy = +0.8 - 0.4 * t
        if abs(py - qy) < 1e-6:    # merged frame: single centroid
            ppl = np.array([[0.0, py]])
        else:
            ppl = np.array([[0.0, py], [0.0, qy]])
        drift = np.tile([0.4, 0.0], (len(bg), 1)) * t
        frames.append(np.concatenate([ppl, bg + drift]))
        m = np.ones(len(frames[-1]), bool)
        masks.append(m)
    d = _run_multi(frames, masks)
    vec = d["flow_vectors"]["vectors"]
    mag = np.linalg.norm(vec, axis=1)
    live = mag > 0.05
    assert live.any()
    # no identity-swap artifact survives: the largest node speed stays at
    # the true walking scale (a swap would register ~1.6 m/s: the 2*0.8 m
    # jump across the merge in one frame)
    assert mag[live].max() < 0.6, mag[live].max()


def test_analyze_sequence_uses_all_frames():
    """Pipeline.analyze_sequence tracks the whole sequence (not just the
    last pair) and measures the generator's known motion."""
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import (
        venue_sequence)

    frames = venue_sequence(n_frames=4, dt=0.5, n_points=8000,
                            n_people=40, extent=15.0, speed=1.0)
    out = Pipeline().analyze_sequence(frames, dt=0.5)
    f = out["flow"]
    vec = np.asarray(f["flow_vectors"]["positions"])
    v = np.asarray(f["flow_vectors"]["vectors"])
    vn = np.linalg.norm(v, axis=1)
    ok = vn > 0.05
    assert ok.any()
    # generator truth: motion toward the exit at (extent, 0)
    gt = np.stack([15.0 - vec[:, 0], -vec[:, 1]], 1)
    gt /= np.maximum(np.linalg.norm(gt, axis=1, keepdims=True), 1e-9)
    cos = float(np.mean(np.sum(v[ok] / vn[ok, None] * gt[ok], axis=1)))
    assert cos > 0.9, cos
    assert 0.2 < f["avg_speed"] < 2.0
