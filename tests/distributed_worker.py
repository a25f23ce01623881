"""Worker process for the two-process ``jax.distributed`` test.

Spawned twice by tests/test_distributed.py (coordinator on localhost).
Each process owns 4 virtual CPU devices; together they form the 8-device
global mesh every other multi-device test simulates in ONE process. This
exercises the real multi-host code path — ``initialize_distributed``
(parallel/mesh.py), global-mesh construction over non-addressable
devices, cross-process dp collectives in the sharded train step, and an
sp-sharded density — and writes the results for the parent to compare
with the single-process answers.

Usage: python distributed_worker.py <pid> <nproc> <port> <outdir>
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, outdir = sys.argv[3], sys.argv[4]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.multihost_utils import process_allgather
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lidar_crowd.parallel.mesh import (
        initialize_distributed, make_mesh)

    initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, jax.devices()
    assert len(jax.local_devices()) == 4

    # -- dp x mp sharded train step (cross-process dp groups) ---------------
    from lidar_crowd.models.train import (
        TrainConfig, make_batch)
    from lidar_crowd.parallel.trainer import (
        make_sharded_train_step, sharded_init)

    cfg = TrainConfig(batch_size=4, n_points=256, grid=8, sa1_samples=64,
                      sa2_samples=16)
    mesh = make_mesh((("dp", 4), ("mp", 2)))
    # every process computes the identical host batch; device_put with a
    # process-spanning sharding is legal for replicated host values
    batch_np = make_batch(np.random.RandomState(0), cfg)
    ss = sharded_init(cfg, mesh)
    step = make_sharded_train_step(cfg, mesh, ss)
    bsh = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("dp")))
           for k, v in batch_np.items()}
    ss1, metrics = step(ss, bsh)
    loss = float(np.asarray(
        process_allgather(metrics["loss"], tiled=True)).reshape(-1)[0])

    # one representative updated param, gathered to the host
    leaves = jax.tree_util.tree_leaves_with_path(ss1.params)
    key0 = min("/".join(str(p) for p in path) for path, _ in leaves)
    leaf0 = dict(("/".join(str(p) for p in path), leaf)
                 for path, leaf in leaves)[key0]
    param0 = np.asarray(process_allgather(leaf0, tiled=True))

    # -- sp-sharded density (stripes split across the two processes) --------
    import dataclasses

    from lidar_crowd.config import MONOLITH_CONFIG
    from lidar_crowd.parallel.spatial import (
        sharded_radius_density)

    pcfg = dataclasses.replace(
        MONOLITH_CONFIG, capacity=dataclasses.replace(
            MONOLITH_CONFIG.capacity, grid_cells_x=32, grid_cells_y=32,
            max_people=64))
    rng = np.random.RandomState(7)
    ppl = rng.uniform(-14, 14, (64, 2)).astype(np.float32)
    pm = np.ones(64, bool)
    smesh = make_mesh((("sp", 8),))
    grid = sharded_radius_density(
        jnp.asarray(ppl), jnp.asarray(pm),
        jnp.asarray([-15.0, -15.0], jnp.float32),
        jnp.asarray(30, jnp.int32), jnp.asarray(30, jnp.int32),
        pcfg, smesh)
    grid_np = np.asarray(process_allgather(grid, tiled=True))

    if pid == 0:
        np.savez(os.path.join(outdir, "worker0.npz"), loss=loss,
                 param0=param0, key0=key0, density=grid_np)
    else:
        np.savez(os.path.join(outdir, f"worker{pid}.npz"), loss=loss,
                 param0=param0, key0=key0, density=grid_np)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
