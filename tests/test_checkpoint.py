"""Orbax checkpoint save/restore round trip (SURVEY.md §5
checkpoint/resume — the analogue of the reference's session
state / .lcap files / DB rows)."""

import jax
import numpy as np
import pytest

from lidar_crowd.models.train import (
    TrainConfig, fit, init_state, restore_checkpoint, save_checkpoint)

TINY = TrainConfig(batch_size=2, n_points=256, grid=8, sa1_samples=64,
                   sa2_samples=16)


def test_checkpoint_roundtrip(tmp_path):
    state, _ = fit(TINY, steps=2, log_every=0)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)

    restored = restore_checkpoint(path, TINY)
    assert int(restored.step) == int(state.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # training resumes from the restored state
    state2, metrics = fit(TINY, steps=1, state=restored, log_every=0)
    assert int(state2.step) == 3
    assert np.isfinite(metrics["loss"])
