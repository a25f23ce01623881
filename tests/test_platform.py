"""What ties the engine to its accelerator, checked on the CPU: where the
compile cache lives, the table of device peaks, the pytree dataclasses
that replaced flax.struct, the main path importing without the neural
extra, and chip_smoke.py refusing to run without a GPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_crowd import pipeline
from lidar_crowd.ops.columns import build_column_grid
from lidar_crowd.types import People, PointCloud
from lidar_crowd.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [None, "custom"])
def test_compilation_cache_dir(monkeypatch, tmp_path, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert pipeline.compilation_cache_dir() == want
    # the CPU backend keeps no persistent cache of its own
    before = jax.config.jax_compilation_cache_dir
    pipeline.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("kind,chip,tflops,gbps", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM", 989.0, 3350.0),
    ("NVIDIA H100 PCIe", "H100 PCIe", 756.0, 2000.0),
    ("NVIDIA A100-SXM4-80GB", None, None, None),
])
def test_device_peaks(kind, chip, tflops, gbps):
    if chip is None:
        with pytest.raises(KeyError, match="no published peaks"):
            profiling.device_peaks(_Dev(kind))
        with pytest.raises(KeyError):
            profiling.roofline(1e12, 1e9, 1.0, device=_Dev(kind))
        return
    peaks = profiling.device_peaks(_Dev(kind))
    assert (peaks["chip"], peaks["bf16_tflops"], peaks["hbm_gbps"]) == (
        chip, tflops, gbps)
    r = profiling.roofline(tflops * 1e12 / 2, 1.0, 1.0, device=_Dev(kind))
    assert r["pct_peak_flops"] == pytest.approx(50.0)
    assert r["bound"] == "compute"


def _pytree_cases():
    pts = np.arange(24, dtype=np.float32).reshape(8, 3)
    cloud = PointCloud.from_numpy(pts, capacity=12)
    people = People(positions=jnp.ones((4, 2)), mask=jnp.ones(4, bool),
                    z=jnp.zeros(4))
    grid = build_column_grid(jnp.asarray(pts), jnp.ones(8, bool),
                             min_cell=1.0, ncx=4, ncy=4, cap=4)
    return {"PointCloud": cloud, "People": people, "ColumnGrid": grid}


@pytest.mark.parametrize("name", ["PointCloud", "People", "ColumnGrid"])
def test_pytree_dataclasses(name):
    obj = _pytree_cases()[name]
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert len(leaves) == len(dataclasses.fields(obj))
    doubled = jax.jit(lambda t: jax.tree_util.tree_map(lambda x: x * 2,
                                                       t))(obj)
    assert type(doubled) is type(obj)
    for a, b in zip(jax.tree_util.tree_leaves(doubled), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b) * 2)
    first = dataclasses.fields(obj)[0].name
    swapped = dataclasses.replace(obj, **{first: 0})
    assert getattr(swapped, first) == 0
    assert getattr(obj, first) is leaves[0]
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, 1)


def test_main_path_imports_without_neural_extra():
    """With flax, optax and orbax unimportable, the analytics pipeline
    still imports and runs; the neural path names the extra it needs."""
    code = """
import sys
class Block:
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("flax", "optax", "orbax"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
from lidar_crowd.pipeline import Pipeline
from lidar_crowd.synthetic import sample_venue
print(Pipeline().analyze(sample_venue())["density"]["total_people"])
assert not any(m.split(".")[0] in ("flax", "optax", "orbax")
               for m in sys.modules)
try:
    import lidar_crowd.neural
except ImportError as e:
    assert "lidar-crowd[neural]" in str(e), e
    print("neural: extra named")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["446", "neural:", "extra", "named"]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
