#!/usr/bin/env python
"""Pre-commit release gate: the fast product subset that round 3 proved
necessary (a broken flagship checkpoint shipped because nothing between
"edit model" and "commit snapshot" executed the artifact).

Runs, in order:
  1. the product test subset — neural serving (executes the committed
     checkpoint), golden pipeline parity, the Streamlit lifecycle, and
     the platform contract (compile cache, peaks, chip_smoke refusing
     the CPU);
  2. a CLI smoke: `lidar-crowd analyze --neural` on a synthetic venue
     must exit 0 and print a people count.

Exit code 0 = safe to commit. Documented in README.md ("Release gate").
Usage: python tools/release_check.py [-q]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRODUCT_TESTS = [
    "tests/test_neural.py",
    "tests/test_pipeline.py",
    "tests/test_app_lifecycle.py",
    "tests/test_platform.py",
]


def main() -> int:
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")

    rc = subprocess.call(
        [sys.executable, "-m", "pytest", "-x", "-q", *PRODUCT_TESTS],
        cwd=REPO, env=env)
    if rc != 0:
        print("RELEASE GATE FAILED: product tests red", file=sys.stderr)
        return rc

    # CLI smoke on a fresh venue through the packaged checkpoint
    code = (
        "import numpy as np, tempfile, os, sys\n"
        "from lidar_crowd.synthetic import "
        "sample_venue\n"
        "from lidar_crowd import cli\n"
        "pts = sample_venue(n_points=2048, n_people=30, seed=11)\n"
        "p = os.path.join(tempfile.mkdtemp(), 'venue.npy')\n"
        "np.save(p, pts)\n"
        "sys.exit(cli.main(['analyze', p, '--neural']))\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=600)
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"")
        out = out.decode("utf-8", "replace") if isinstance(out, bytes) \
            else out
        print("RELEASE GATE FAILED: CLI neural smoke hung (600s)\n"
              + out[-1000:], file=sys.stderr)
        return 1
    if proc.returncode != 0 or "people" not in proc.stdout.lower():
        print("RELEASE GATE FAILED: CLI neural smoke\n"
              + proc.stdout[-1000:] + proc.stderr[-1000:],
              file=sys.stderr)
        return proc.returncode or 1

    print("release gate: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
