"""Profiling harness tests."""

import jax.numpy as jnp
import numpy as np

from lidar_crowd.utils import profiling


def test_stage_timing_registry():
    profiling.reset_timings()
    with profiling.stage("unit-test-stage", annotate=False):
        _ = sum(range(1000))
    t = profiling.timings()
    assert t["unit-test-stage"]["count"] == 1
    assert t["unit-test-stage"]["mean_ms"] >= 0
    assert "unit-test-stage" in profiling.report()


def test_device_timer_runs():
    import jax
    f = jax.jit(lambda x: jnp.sum(x * 2))
    dt = profiling.device_timer(
        f, make_input=lambda i: (jnp.ones((64,)) * i,), iters=2, warmup=1)
    assert dt >= 0


def test_desktop_module_imports():
    # UI glue cannot run headless; the module itself must import cleanly
    import lidar_crowd.desktop as d
    assert callable(d.main)


def test_streamlit_app_importable_without_streamlit():
    import lidar_crowd.app as a
    assert hasattr(a, "main")
