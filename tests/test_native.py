"""Native C++ parser vs NumPy fallback parity + speed sanity."""

import time

import numpy as np
import pytest

from lidar_crowd.utils import io as pio
from lidar_crowd.utils import native

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="g++ toolchain unavailable")


@needs_native
def test_text_parser_matches_python():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-100, 100, (5000, 3))
    lines = ["# header"]
    for i, p in enumerate(pts):
        sep = [" ", ",", ";"][i % 3]
        lines.append(sep.join(f"{v:.6f}" for v in p))
        if i % 97 == 0:
            lines.append("garbage line")
    data = ("\n".join(lines) + "\n").encode()
    got = native.parse_xyz_text(data)
    np.testing.assert_allclose(got, pts, atol=1e-6)


@needs_native
def test_exponent_notation():
    data = b"1.5e2 -2.5E-1 3e0\n"
    got = native.parse_xyz_text(data)
    np.testing.assert_allclose(got, [[150.0, -0.25, 3.0]])


@needs_native
def test_las_native_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    pts = rng.uniform(-50, 50, (20000, 3))
    p = str(tmp_path / "cloud.las")
    pio.save_points(p, pts)
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-5)


@needs_native
def test_large_text_uses_native_and_is_fast(tmp_path):
    rng = np.random.RandomState(2)
    pts = rng.uniform(-100, 100, (200_000, 3))
    p = str(tmp_path / "big.xyz")
    pio.save_points(p, pts)
    t0 = time.time()
    out = pio.load_points(p)
    dt = time.time() - t0
    assert out.shape == (200_000, 3)
    np.testing.assert_allclose(out, pts, atol=1e-6)
    # native parses ~10M rows/s; 200k rows should be well under a second
    assert dt < 2.0, f"native text parse took {dt:.1f}s"


def test_fallback_without_native(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    data = b"1 2 3\n4 5 6\n" * 10_000  # big enough to hit the native path
    pts = pio._load_text(data)
    assert pts.shape == (20_000, 3)
