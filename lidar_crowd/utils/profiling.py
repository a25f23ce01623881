"""Tracing / timing / observability.

The reference has no profiling at all (SURVEY.md §5 — only st.spinner
UX wrappers). This module provides:

  - ``stage``: a context manager that records wall time per pipeline
    stage and optionally emits a ``jax.profiler`` trace annotation so
    stages show up named in device traces;
  - ``device_timer``: steady-state seconds per call of a jitted
    function, fenced by ``block_until_ready``;
  - ``trace``: wrapper around jax.profiler.trace for capturing a
    TensorBoard-loadable trace directory;
  - ``roofline``: achieved rates against the device's published peaks;
  - a process-wide stage-timing registry (``timings``, ``report``).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np

logger = logging.getLogger("lidar_crowd")

_TIMINGS: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def stage(name: str, annotate: bool = True):
    """Time a pipeline stage; nests with jax profiler traces."""
    ctx = contextlib.nullcontext()
    if annotate:
        try:
            import jax.profiler
            ctx = jax.profiler.TraceAnnotation(name)
        except Exception:
            pass
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    _TIMINGS[name].append(dt)
    logger.debug("stage %s: %.1f ms", name, dt * 1000)


def timings() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, vals in _TIMINGS.items():
        arr = np.asarray(vals)
        out[name] = {"count": len(vals), "total_s": float(arr.sum()),
                     "mean_ms": float(arr.mean() * 1000),
                     "last_ms": float(arr[-1] * 1000)}
    return out


def reset_timings() -> None:
    _TIMINGS.clear()


def report() -> str:
    lines = [f"{'stage':<32} {'count':>5} {'mean ms':>10} {'total s':>9}"]
    for name, s in sorted(timings().items()):
        lines.append(f"{name:<32} {s['count']:>5} {s['mean_ms']:>10.2f} "
                     f"{s['total_s']:>9.2f}")
    return "\n".join(lines)


def device_timer(fn: Callable, make_input: Callable[[int], tuple],
                 iters: int = 4, warmup: int = 1) -> float:
    """Median seconds per call of ``fn`` after ``warmup`` calls.

    make_input(i) -> args tuple, distinct per call so no call can reuse
    an earlier result. Each call's result is waited for with
    ``block_until_ready`` inside its timed region."""
    import jax
    for i in range(warmup):
        jax.block_until_ready(fn(*make_input(i)))
    ts = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*make_input(warmup + i)))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile into ``logdir`` (TensorBoard format)."""
    import jax.profiler
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# ---------------------------------------------------------------------------
# Roofline accounting
# ---------------------------------------------------------------------------

# Published dense peaks per device, keyed by ``jax.Device.device_kind``.
# Sources: NVIDIA H100 data sheet — SXM5: 989 TFLOP/s bf16 (dense),
# 3.35 TB/s HBM3; PCIe: 756 TFLOP/s bf16 (dense; 1,513 with sparsity),
# 2.0 TB/s HBM2e. Both assume the card's full power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"chip": "H100 SXM", "bf16_tflops": 989.0,
                              "hbm_gbps": 3350.0},
    "NVIDIA H100 PCIe": {"chip": "H100 PCIe", "bf16_tflops": 756.0,
                         "hbm_gbps": 2000.0},
}


def device_peaks(device=None) -> Dict[str, float]:
    """Peak FLOP/s and bandwidth for ``device`` (default: first jax
    device). A device not in DEVICE_PEAKS is an error, not a default."""
    import jax
    if device is None:
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}")
    return dict(DEVICE_PEAKS[kind])


def roofline(flops: float, bytes_accessed: float, seconds: float,
             device=None) -> Dict[str, float]:
    """Achieved vs peak for one timed kernel/program.

    Returns achieved TFLOP/s and GB/s plus percent-of-peak numbers and
    which roof binds (higher fraction of its peak). Percentages are vs
    the dense bf16 tensor-core peak; a pure-f32 program sits lower."""
    peaks = device_peaks(device)
    out = {
        "achieved_tflops": flops / seconds / 1e12,
        "achieved_gbps": bytes_accessed / seconds / 1e9,
        "chip": peaks["chip"],
    }
    out["pct_peak_flops"] = 100.0 * out["achieved_tflops"] / \
        peaks["bf16_tflops"]
    out["pct_peak_bw"] = 100.0 * out["achieved_gbps"] / peaks["hbm_gbps"]
    out["bound"] = ("compute" if out["pct_peak_flops"]
                    >= out["pct_peak_bw"] else "memory")
    return out
