"""Real multi-process distributed bring-up (VERDICT r2 item 4).

Every other multi-device test simulates the 8-device mesh inside one
process. Here two OS processes (4 virtual CPU devices each) join through
``jax.distributed`` with a localhost coordinator — the DCN code path the
SURVEY §5 design promises — run one dp x mp sharded train step and one
sp-sharded density, and the parent asserts their results match the
single-process mesh bit-for-bit (CPU: identical HLO, deterministic
collective reduction order).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("dist"))
    port = _free_port()
    # pin the workers to 4 virtual CPU devices each
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), "2", str(port), outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-4000:]}"
    return {pid: np.load(os.path.join(outdir, f"worker{pid}.npz"))
            for pid in range(2)}


def _single_process_reference():
    """The same computations on the one-process 8-device mesh."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lidar_crowd.config import MONOLITH_CONFIG
    from lidar_crowd.models.train import (
        TrainConfig, make_batch)
    from lidar_crowd.parallel.mesh import make_mesh
    from lidar_crowd.parallel.spatial import (
        sharded_radius_density)
    from lidar_crowd.parallel.trainer import (
        make_sharded_train_step, sharded_init)

    cfg = TrainConfig(batch_size=4, n_points=256, grid=8, sa1_samples=64,
                      sa2_samples=16)
    mesh = make_mesh((("dp", 4), ("mp", 2)))
    batch_np = make_batch(np.random.RandomState(0), cfg)
    ss = sharded_init(cfg, mesh)
    step = make_sharded_train_step(cfg, mesh, ss)
    bsh = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("dp")))
           for k, v in batch_np.items()}
    ss1, metrics = step(ss, bsh)
    leaves = jax.tree_util.tree_leaves_with_path(ss1.params)
    key0 = min("/".join(str(p) for p in path) for path, _ in leaves)
    leaf0 = dict(("/".join(str(p) for p in path), leaf)
                 for path, leaf in leaves)[key0]

    pcfg = dataclasses.replace(
        MONOLITH_CONFIG, capacity=dataclasses.replace(
            MONOLITH_CONFIG.capacity, grid_cells_x=32, grid_cells_y=32,
            max_people=64))
    rng = np.random.RandomState(7)
    ppl = rng.uniform(-14, 14, (64, 2)).astype(np.float32)
    smesh = make_mesh((("sp", 8),))
    grid = sharded_radius_density(
        jnp.asarray(ppl), jnp.asarray(np.ones(64, bool)),
        jnp.asarray([-15.0, -15.0], jnp.float32),
        jnp.asarray(30, jnp.int32), jnp.asarray(30, jnp.int32),
        pcfg, smesh)
    return (float(metrics["loss"]), key0, np.asarray(leaf0),
            np.asarray(grid))


def test_two_process_agrees_with_single_process(worker_outputs):
    loss, key0, param0, grid = _single_process_reference()
    w0 = worker_outputs[0]
    assert str(w0["key0"]) == key0
    assert abs(float(w0["loss"]) - loss) < 1e-5
    np.testing.assert_allclose(w0["param0"], param0, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(w0["density"], grid, atol=0)


def test_both_processes_agree(worker_outputs):
    w0, w1 = worker_outputs[0], worker_outputs[1]
    assert float(w0["loss"]) == float(w1["loss"])
    np.testing.assert_array_equal(w0["param0"], w1["param0"])
    np.testing.assert_array_equal(w0["density"], w1["density"])
