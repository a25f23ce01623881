"""Determinism: identical inputs must produce bit-identical results
(no nondeterministic reductions anywhere in the jitted pipeline) — the
single-process analogue of race detection (SURVEY.md §5)."""

import numpy as np

from lidar_crowd.pipeline import Pipeline


def test_pipeline_bitwise_deterministic(fixture_points):
    pipe = Pipeline()
    a = pipe.analyze(fixture_points)
    b = pipe.analyze(fixture_points)
    np.testing.assert_array_equal(a["density"]["density_grid"],
                                  b["density"]["density_grid"])
    np.testing.assert_array_equal(
        a["flow"]["flow_vectors"]["vectors"],
        b["flow"]["flow_vectors"]["vectors"])
    assert a["density"]["hotspots"] == b["density"]["hotspots"]
    assert a["flow"]["bottlenecks"] == b["flow"]["bottlenecks"]


def test_training_step_deterministic():
    import jax.numpy as jnp

    from lidar_crowd.models.train import (
        TrainConfig, init_state, make_batch, train_step)
    cfg = TrainConfig(batch_size=2, n_points=256, grid=8, sa1_samples=64,
                      sa2_samples=16)
    batch = {k: jnp.asarray(v)
             for k, v in make_batch(np.random.RandomState(0),
                                    cfg).items()}
    # donation forbids reuse; build two fresh states
    _, m1 = train_step(init_state(cfg), batch, cfg)
    _, m2 = train_step(init_state(cfg), batch, cfg)
    assert float(m1["loss"]) == float(m2["loss"])
