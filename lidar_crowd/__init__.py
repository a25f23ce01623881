"""LiDAR crowd-analytics engine on one accelerator.

A JAX/XLA re-design of the capabilities of
FortuneMU2025/LIDAR_AI_Recommendation_Software: point-cloud ingest,
preprocessing (outlier rejection, ground split, person clustering), crowd
density and flow analytics, recommendations, reporting and persistence —
built with static shapes, masked fixed-capacity tensors and jax.sharding
for multi-device scale.
"""

__version__ = "0.1.0"

from lidar_crowd.config import (  # noqa: F401
    MODULAR_CONFIG,
    MONOLITH_CONFIG,
    PipelineConfig,
)
