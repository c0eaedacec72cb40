"""Which engine runs where: the one module that reads the backend.

Set-abstraction pooling (models/fused_sa.banded_max_pool) has two
implementations with different coverage:

- "triton": the Pallas kernels of ops/pallas/band_max.py, compiled for
  the GPU through Triton. Each query tile sweeps its exact slab, so the
  pooled set is every in-radius point (cap-free).
- "xla_band": fused_sa.xla_banded_max, a static band of
  ceil(window / tile) tiles around each tile, with the window sized by
  ops.neighbors.window_for from the declared extent. It under-covers
  slabs denser than the window assumes; the Registrar audits that.
"""

from __future__ import annotations

from typing import Optional

import jax


def pooling_engine(backend: Optional[str] = None) -> str:
    """The SA pooling engine for `backend` (default: JAX's default)."""
    backend = backend or jax.default_backend()
    return "triton" if backend == "gpu" else "xla_band"
