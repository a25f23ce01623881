"""Device-mesh helpers.

The reference has no distributed story at all (SURVEY.md §2 P1/P2). The
framework scales through ``jax.sharding``: a 2-D logical mesh with a
``dp`` (data/batch) axis and an ``mp`` (model/tensor) axis for training,
and an ``sp`` (spatial) axis for sharded venue analytics
(parallel/spatial.py). Multi-host bring-up goes through
``jax.distributed.initialize`` (initialize_distributed) and the same mesh
API — XLA compiles the collectives (NCCL between GPUs).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axes: Sequence[Tuple[str, int]] = (("dp", -1),),
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a mesh from (name, size) axes; one size may be -1 (infer)."""
    devices = list(devices if devices is not None else jax.devices())
    sizes = [s for _, s in axes]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh wants {total} devices, have "
                         f"{len(devices)}")
    arr = np.array(devices[:total]).reshape(sizes)
    return Mesh(arr, tuple(n for n, _ in axes))


def train_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Standard training mesh: mp=2 when the device count is even
    (tensor-parallel pairs riding the fastest links), else pure dp."""
    devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    n = len(devices)
    mp = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh((("dp", n // mp), ("mp", mp)), devices)


def spatial_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D spatial mesh for venue-sharded analytics."""
    devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return make_mesh((("sp", len(devices)),), devices)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (jax.distributed). No-op when single-process
    env vars are absent and no explicit coordinator is given."""
    import os
    if coordinator is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes, process_id=process_id)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (batch) dimension."""
    return NamedSharding(mesh, P(axis))
