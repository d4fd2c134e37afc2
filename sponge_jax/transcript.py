"""Compiled Fiat–Shamir transcripts: a whole absorb/squeeze schedule as ONE
fused device program.

The interactive ``PoseidonSponge`` API pays a host↔device round trip per step —
fine for exploration, ruinous for production transcript throughput (measured
~60x below permutation peak).  A transcript's *structure* (how many elements are
absorbed/squeezed at each step) is static even though its *values* differ per
lane, so the duplex bookkeeping (mode, rate index, permute placement — exactly
the reference state machine, /root/reference/src/poseidon/mod.rs:121-182,
232-341) can run at trace time, leaving a single jitted chain of batched
permutations and rate-row additions on device.

    plan = compile_transcript(cfg, [Absorb(3), SqueezeNative(2), Absorb(1),
                                    SqueezeNative(1)], batch=1 << 16)
    outs = plan(elems)   # (total_absorbed, L, B) -> (total_squeezed, L, B)

Outputs are canonical limb planes (from_mont applied once at the end).
Bit-exactness vs the interactive sponge is enforced in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from .ops import montgomery as mont
from .poseidon.config import PoseidonConfig
from .poseidon.permutation import batched_permute


@dataclass(frozen=True)
class Absorb:
    """Absorb ``num_elements`` pre-encoded native field elements."""

    num_elements: int


@dataclass(frozen=True)
class SqueezeNative:
    """Squeeze ``num_elements`` native field elements."""

    num_elements: int


Step = Union[Absorb, SqueezeNative]


def _replay(
    cfg: PoseidonConfig,
    steps: Sequence[Step],
    elems,
    backend: str,
    state=None,
    mode: str = "absorbing",
    index: int = 0,
    return_state: bool = False,
):
    """Trace-time replay of the duplex state machine over device values.

    Starts from ``(state, mode, index)`` — a fresh zero sponge by default —
    so segments of a longer transcript can be compiled independently (see
    ``sponge_jax.lazy``).  With ``return_state`` the final device state is
    returned alongside the squeezed plane; the final (mode, index) bookkeeping
    is host-static and computed by ``segment_bookkeeping``.
    """
    fs = cfg.field
    L, B = elems.shape[-2], elems.shape[-1]
    if state is None:
        state = jnp.zeros((cfg.t, L, B), dtype=jnp.int32)
    pos = 0
    outs = []

    def permute(st):
        return batched_permute(cfg, st, backend)

    def add_rows(st, start, chunk):
        lo = cfg.capacity + start
        rows = mont.mont_add(fs, st[lo : lo + chunk.shape[0]], chunk)
        return jnp.concatenate(
            [st[:lo], rows, st[lo + chunk.shape[0] :]], axis=0
        )

    for step in steps:
        if isinstance(step, Absorb):
            n = step.num_elements
            if n == 0:
                continue
            chunk_elems = elems[pos : pos + n]
            pos += n
            # absorb entry (mod.rs:238-253)
            if mode == "absorbing":
                start = index
                if start == cfg.rate:
                    state = permute(state)
                    start = 0
            else:
                state = permute(state)
                start = 0
            # absorb_internal (mod.rs:121-150)
            off = 0
            remaining = n
            while True:
                if start + remaining <= cfg.rate:
                    state = add_rows(state, start, chunk_elems[off : off + remaining])
                    mode, index = "absorbing", start + remaining
                    break
                take = cfg.rate - start
                state = add_rows(state, start, chunk_elems[off : off + take])
                state = permute(state)
                off += take
                remaining -= take
                start = 0
        elif isinstance(step, SqueezeNative):
            n = step.num_elements
            # squeeze entry (mod.rs:321-341)
            if mode == "absorbing":
                state = permute(state)
                start = 0
            else:
                start = index
                if start == cfg.rate:
                    state = permute(state)
                    start = 0
            # squeeze_internal (mod.rs:153-182) incl. the no-permute quirk
            remaining = n
            while True:
                if start + remaining <= cfg.rate:
                    lo = cfg.capacity + start
                    outs.append(state[lo : lo + remaining])
                    mode, index = "squeezing", start + remaining
                    break
                take = cfg.rate - start
                lo = cfg.capacity + start
                outs.append(state[lo : lo + take])
                if remaining != cfg.rate:
                    state = permute(state)
                remaining -= take
                start = 0
        else:
            raise TypeError(f"unknown transcript step: {step!r}")

    squeezed = (
        jnp.concatenate(outs, axis=0)
        if outs
        else jnp.zeros((0, L, B), dtype=jnp.int32)
    )
    canonical = mont.from_mont(fs, squeezed)
    if return_state:
        return canonical, state
    return canonical


def segment_bookkeeping(
    cfg: PoseidonConfig, steps: Sequence[Step], mode: str, index: int
) -> Tuple[str, int]:
    """Final (mode, index) after replaying ``steps`` from (mode, index).

    Mirrors exactly the host-static control flow of ``_replay`` (the reference
    duplex bookkeeping, mod.rs:121-182, 232-341) without touching device
    values; equivalence with the interactive sponge is asserted in tests.
    """
    for step in steps:
        if isinstance(step, Absorb):
            n = step.num_elements
            if n == 0:
                continue
            start = index if mode == "absorbing" else 0
            if start == cfg.rate:
                start = 0
            remaining = n
            while start + remaining > cfg.rate:
                remaining -= cfg.rate - start
                start = 0
            mode, index = "absorbing", start + remaining
        elif isinstance(step, SqueezeNative):
            start = index if mode == "squeezing" else 0
            if start == cfg.rate:
                start = 0
            remaining = step.num_elements
            while start + remaining > cfg.rate:
                remaining -= cfg.rate - start
                start = 0
            mode, index = "squeezing", start + remaining
        else:
            raise TypeError(f"unknown transcript step: {step!r}")
    return mode, index


def transcript_shape(steps: Sequence[Step]) -> Tuple[int, int]:
    """(total absorbed elements, total squeezed elements) of a schedule."""
    a = sum(s.num_elements for s in steps if isinstance(s, Absorb))
    q = sum(s.num_elements for s in steps if isinstance(s, SqueezeNative))
    return a, q


def compile_transcript(
    cfg: PoseidonConfig,
    steps: Sequence[Step],
    backend: str = "auto",
):
    """Compile a transcript schedule into one jitted device function.

    Returns ``fn(elems)`` mapping a ``(total_absorbed, L, B)`` Montgomery
    element plane (all absorbed values, concatenated in schedule order) to a
    ``(total_squeezed, L, B)`` canonical output plane.
    """
    steps = tuple(steps)
    total_absorbed, _ = transcript_shape(steps)

    @jax.jit
    def run(elems):
        # Static trace-time shape check: jnp slicing clamps out-of-range
        # slices, so an undersized plane would otherwise silently absorb fewer
        # elements than the schedule specifies and diverge from the oracle.
        if elems.shape[0] != total_absorbed:
            raise ValueError(
                f"transcript input plane has {elems.shape[0]} element rows; "
                f"the schedule absorbs {total_absorbed}"
            )
        return _replay(cfg, steps, elems, backend)

    return run
