"""Segment compiler for the sponge's lazy (dispatch-batched) mode, plus the
backwards-compatible ``LazyPoseidonSponge`` name.

Since round 3 the segment-batched dispatch lives in ``PoseidonSponge`` itself
and is the DEFAULT (``sponge.py``): absorbs queue host-side and each squeeze
flushes the pending ``[Absorb..., Squeeze]`` segment as one fused jitted
program (``transcript._replay`` from a live state), cached here by
(config, start mode/index, step shapes, backend).  The step-by-step eager
dispatch pattern — several small device dispatches per duplex step — is the
``lazy=False`` escape hatch.

Bit-exactness: segments replay the exact reference duplex machine
(/root/reference/src/poseidon/mod.rs:121-182, 232-341) and are tested against
the eager sponge and the scalar oracle on interleaved schedules
(tests/test_lazy_sponge.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax

from .poseidon.config import PoseidonConfig
from .sponge import PoseidonSponge
from .transcript import _replay, segment_bookkeeping


# Bounded: a long-running process issuing irregular absorb/squeeze segment
# shapes would otherwise compile and retain XLA programs without limit (the
# same per-process compiler-state accumulation tests/conftest.py documents as
# a crash trigger).  LRU eviction drops the jitted closure — and with it the
# PjitFunction's compiled-executable cache — once 128 distinct
# (config, segment shape, start mode/index, backend) keys are live; hot
# Fiat–Shamir loops reuse a handful of keys and never evict.
SEGMENT_CACHE_SIZE = 128


@functools.lru_cache(maxsize=SEGMENT_CACHE_SIZE)
def _segment_fn(
    cfg: PoseidonConfig,
    steps: Tuple,
    start_mode: str,
    start_index: int,
    backend: str,
):
    """Jitted ``(state, elems) -> (squeezed_canonical, new_state)`` for one
    segment, plus the host-static final (mode, index)."""

    @jax.jit
    def run(state, elems):
        return _replay(
            cfg,
            steps,
            elems,
            backend,
            state=state,
            mode=start_mode,
            index=start_index,
            return_state=True,
        )

    end_mode, end_index = segment_bookkeeping(cfg, steps, start_mode, start_index)
    return run, end_mode, end_index


class LazyPoseidonSponge(PoseidonSponge):
    """Backwards-compatible alias: ``PoseidonSponge`` is lazy by default now."""

    def __init__(self, cfg: PoseidonConfig, batch_size: int = 1, backend: str = "auto"):
        super().__init__(cfg, batch_size, lazy=True, backend=backend)
