"""Device-mesh helpers for data-parallel sponge workloads.

The reference library is single-threaded (SURVEY.md §2.3 — no parallelism of any
kind); all distribution here is additive capability.  The natural
parallel axis for sponge workloads is the *batch of independent sponge states*:
permutations are embarrassingly parallel across lanes, so a 1-D ``data`` mesh with
the batch axis sharded communicates only when tree reductions shrink a layer below
the per-device block (see ``parallel.merkle``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (t, L, B) / (k, L, B) planes: batch axis over the data mesh."""
    return NamedSharding(mesh, P(None, None, DATA_AXIS))


def leaf_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (L, N) leaf planes: leaf axis over the data mesh."""
    return NamedSharding(mesh, P(None, DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
