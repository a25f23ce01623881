"""Sort-based permutation primitive for the density bucket build
(ops/bucket_density.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def permutation_scatter(perm: jnp.ndarray, val: jnp.ndarray
                        ) -> jnp.ndarray:
    """out[perm[k]] = val[k] for a PERMUTATION ``perm`` — via one sort.

    Sorting (perm, val) by perm leaves val in exactly out-order.
    """
    _, out = jax.lax.sort((perm, val), num_keys=1)
    return out
