"""Failure detection and graceful degradation.

The reference's only failure handling is logged-error-and-return-None
around DB calls (SURVEY.md §5). This module provides:

  - ``device_healthy``: a bounded-time liveness probe (tiny matmul with a
    host read-back, executed in a watchdog thread so a hung device call
    cannot hang the caller);
  - ``retry``: exponential-backoff retry for transient errors;
  - ``FallbackPipeline``: an explicit opt-in (``lidar-crowd analyze
    --fallback-cpu``) that runs the device pipeline and, on failure,
    degrades to the CPU oracle (oracle/reference.py) — the *same results*
    (bit-parity is what the test suite asserts) at CPU speed, marked
    ``degraded``. No benchmark or chip check runs through it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

logger = logging.getLogger("lidar_crowd.resilience")


def _default_probe():
    import jax
    import jax.numpy as jnp
    x = jnp.ones((128, 128))
    return float(jnp.sum(jnp.matmul(x, x,
                                    precision=jax.lax.Precision.HIGHEST)))


def device_healthy(timeout_s: float = 10.0, attempts: int = 3,
                   retry_delay_s: float = 5.0, probe=None) -> bool:
    """True when the default device executes + returns within budget.

    A single failed probe does not condemn the device: retry up to
    ``attempts`` times with a flat delay. A probe that *hangs* (timeout)
    counts as one failed attempt — the per-attempt budget is
    ``timeout_s``.
    """
    if probe is None:
        probe = _default_probe

    for i in range(attempts):
        # A plain daemon thread, NOT ThreadPoolExecutor: pool workers are
        # non-daemon, so a probe hung inside a device call would block
        # interpreter exit. A daemon thread lets the process exit.
        box: Dict[str, object] = {}

        def run():
            try:
                # coerce + finiteness-check INSIDE the guarded worker: a
                # custom probe returning a non-numeric value must read as
                # an unhealthy probe, not a TypeError out of the caller
                box["val"] = float(probe())
                box["ok"] = bool(np.isfinite(box["val"]))
            except Exception as e:  # runtime error, no device
                box["err"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=timeout_s)
        if box.get("ok"):
            return True
        if t.is_alive():
            logger.warning("device health probe timed out "
                           "(attempt %d/%d, %.0fs)", i + 1, attempts,
                           timeout_s)
        else:
            # %r, not %s: exceptions raised with empty messages must
            # still log their class
            logger.warning("device health probe failed (attempt %d/%d):"
                           " %r", i + 1, attempts,
                           box.get("err", box.get("val")))
        if i + 1 < attempts:
            time.sleep(retry_delay_s)
    return False


def retry(fn: Callable, attempts: int = 3, base_delay_s: float = 1.0,
          retryable=(Exception,)):
    """Call ``fn`` with exponential backoff on retryable errors."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retryable as e:
            last = e
            delay = base_delay_s * (2 ** i)
            logger.warning("attempt %d/%d failed (%r); retrying in %.1fs",
                           i + 1, attempts, e, delay)
            time.sleep(delay)
    raise last


class FallbackPipeline:
    """Pipeline wrapper that degrades to the CPU oracle on device
    failure. The oracle reimplements the reference algorithms exactly
    (the golden tests assert parity), so results stay consistent."""

    def __init__(self, pipeline=None, health_timeout_s: float = 20.0,
                 probe_first: bool = False):
        from lidar_crowd.pipeline import Pipeline
        self.pipeline = pipeline or Pipeline()
        self.health_timeout_s = health_timeout_s
        self.probe_first = probe_first
        self.fallbacks = 0

    def analyze(self, points: np.ndarray) -> Dict:
        # attempts=1: the probe gates a *fast failover* to the CPU oracle —
        # retrying transients here would delay degraded-mode results
        if self.probe_first and not device_healthy(self.health_timeout_s,
                                                   attempts=1):
            return self._analyze_oracle(points)
        try:
            return self.pipeline.analyze(points)
        except Exception as e:
            logger.error("device pipeline failed (%s); "
                         "falling back to CPU oracle", e)
            return self._analyze_oracle(points)

    def _analyze_oracle(self, points: np.ndarray) -> Dict:
        from lidar_crowd.oracle import (
            reference as ref)
        from lidar_crowd.utils.recommendations \
            import generate_recommendations

        self.fallbacks += 1
        variant = self.pipeline.config.preprocess.variant
        out = ref.analyze(np.asarray(points, np.float64), variant=variant)
        density = out["density"]
        # normalise the oracle's monolith key to the pipeline's layout
        if "density_grid" not in density and "density_map" in density:
            density["density_grid"] = density["density_map"]
        recommendations = generate_recommendations(
            density, out["flow"], self.pipeline.config.recommend)
        return {
            "processed": out["processed"],
            "people": None,
            "coordinate_offset": np.zeros(3),
            "density": density,
            "flow": out["flow"],
            "recommendations": recommendations,
            "degraded": True,
        }
