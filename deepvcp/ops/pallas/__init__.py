"""Pallas kernels for the GPU, compiled through Triton. Each has a plain
JAX reference elsewhere in ops/ or models/; the CPU tests compare them in
interpret mode."""

from deepvcp.ops.pallas.band_max import (
    banded_masked_max,
    banded_masked_max_grad,
)

__all__ = [
    "banded_masked_max",
    "banded_masked_max_grad",
]
