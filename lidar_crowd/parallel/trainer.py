"""Sharded CrowdNet training: dp (batch) x mp (tensor) parallelism.

The jitted train step runs over a 2-D mesh: the batch is sharded on
``dp``; Dense/Conv kernels (and their optimizer moments) are sharded on
their output-feature axis over ``mp``. Shardings are declared with
``NamedSharding`` on inputs/outputs and XLA inserts the collectives
(gradient psum over dp, activation all-gathers over mp) — no
hand-written communication (SURVEY.md §5 distributed design).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lidar_crowd.models.train import (
    TrainConfig, TrainState, init_state, loss_fn, make_batch)


def param_spec(path: Tuple, leaf, mp_size: int) -> P:
    """Tensor-parallel sharding rule: shard the output-feature (last) axis
    of every matmul/conv kernel over mp when divisible (tiny heads with
    1-2 output channels stay replicated); biases and scalars replicate."""
    names = [getattr(p, "key", str(p)) for p in path]
    # matches Conv/Dense "kernel" and the SA layers' explicit
    # "mlp{i}_kernel" params (models/crowdnet.py SetAbstraction)
    if (leaf.ndim >= 2 and names and names[-1].endswith("kernel")
            and leaf.shape[-1] % mp_size == 0
            and leaf.shape[-1] >= mp_size):
        return P(*([None] * (leaf.ndim - 1) + ["mp"]))
    return P()


def make_param_shardings(mesh: Mesh, params):
    mp_size = dict(zip(mesh.axis_names, mesh.devices.shape)).get("mp", 1)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_spec(path, leaf, mp_size)),
        params)


def make_state_shardings(mesh: Mesh, state: TrainState):
    """Shard params and optimizer moments identically; replicate the
    scalar step."""
    pshard = make_param_shardings(mesh, state.params)

    def opt_shard(leaf):
        # optax moments mirror the param tree inside nested tuples; match
        # by shape: any leaf with a matching param shape gets its sharding
        return None

    # Build by structural mapping: adamw state = (ScaleByAdamState(mu, nu),
    # ...) whose mu/nu share the params tree structure.
    flat_p, treedef_p = jax.tree_util.tree_flatten(pshard)

    def map_like(tree):
        leaves, td = jax.tree_util.tree_flatten(tree)
        if td == treedef_p:
            return jax.tree_util.tree_unflatten(td, flat_p)
        return jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P()), tree)

    opt_state = jax.tree_util.tree_map(
        map_like, state.opt_state,
        is_leaf=lambda x: jax.tree_util.tree_structure(x) == treedef_p)

    return state.replace(
        step=NamedSharding(mesh, P()),
        params=pshard,
        opt_state=opt_state,
    )


def make_batch_shardings(mesh: Mesh, batch: Dict):
    return {k: NamedSharding(mesh, P("dp"))
            for k in batch}


def sharded_init(cfg: TrainConfig, mesh: Mesh) -> TrainState:
    """Initialise a TrainState and place it according to the sharding
    rules (device_put with NamedSharding trees)."""
    state = init_state(cfg)
    shardings = make_state_shardings(mesh, state)
    params = jax.device_put(state.params, shardings.params)
    opt_state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s) if hasattr(x, "shape") else x,
        state.opt_state, shardings.opt_state)
    return state.replace(params=params, opt_state=opt_state)


def make_sharded_train_step(cfg: TrainConfig, mesh: Mesh, state):
    """jit with explicit in/out shardings over the mesh."""
    # the sharding pytree must share TrainState's static metadata
    # (apply_fn/tx are non-pytree fields), so build it via replace()
    state_shardings = make_state_shardings(mesh, state)

    def step_fn(st, batch):
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (_, metrics), grads = grad_fn(st.params, state.apply_fn, batch,
                                      cfg)
        return st.apply_gradients(grads=grads), metrics

    batch_sh = {k: NamedSharding(mesh, P("dp"))
                for k in ("points", "mask", "venue_min", "venue_size",
                          "density", "flow", "congestion")}
    # metrics are scalars: one replicated spec for the whole subtree
    # (a prefix pytree, so loss_fn may add/remove metric keys freely)
    return jax.jit(
        step_fn,
        in_shardings=(state_shardings, batch_sh),
        out_shardings=(state_shardings, NamedSharding(mesh, P())),
        donate_argnums=(0,),
    )


def run_sharded_steps(cfg: TrainConfig, mesh: Mesh,
                      n_steps: int = 1) -> Dict:
    """End-to-end sharded training driver (used by dryrun_multichip and
    the multi-device tests): init, place, step n times, return metrics."""
    state = sharded_init(cfg, mesh)
    step = make_sharded_train_step(cfg, mesh, state)
    rng = np.random.RandomState(cfg.seed)
    metrics = {}
    batch_sh = {k: NamedSharding(mesh, P("dp"))
                for k in ("points", "mask", "venue_min", "venue_size",
                          "density", "flow", "congestion")}
    for _ in range(n_steps):
        batch = make_batch(rng, cfg)
        batch = {k: jax.device_put(jnp.asarray(v), batch_sh[k])
                 for k, v in batch.items()}
        state, metrics = step(state, batch)
    return {k: float(v) for k, v in metrics.items()}
