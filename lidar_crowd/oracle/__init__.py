"""CPU NumPy oracle (reference-faithful) implementations."""

from lidar_crowd.oracle import reference  # noqa: F401
