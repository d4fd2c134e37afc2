"""Sharded batched-permutation and transcript throughput paths.

Data parallelism over the sponge-state batch axis is the whole story for duplex
sponges (SURVEY.md §2.3: a t<=9-element permutation has no tensor/pipeline
dimension worth splitting; scaling comes from independent states).  These helpers
wrap the batched permutation in ``shard_map`` so each device advances its local slice of
the batch with zero communication, and expose a scaling-efficiency probe used by
the bench harness.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..poseidon.config import PoseidonConfig
from ..poseidon.permutation import batched_permute
from .mesh import DATA_AXIS, batch_sharding


def sharded_permute_fn(cfg: PoseidonConfig, mesh: Mesh, backend: str = "auto"):
    """Returns a jitted (t, L, B)->(t, L, B) permutation sharded over the mesh.

    B must be divisible by the mesh size; each device permutes its local
    (t, L, B/D) slice — embarrassingly parallel, no communication.
    """

    def local(chunk):
        return batched_permute(cfg, chunk, backend)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, None, DATA_AXIS),
        out_specs=P(None, None, DATA_AXIS),
    )
    return jax.jit(fn)


def sharded_state(cfg: PoseidonConfig, mesh: Mesh, batch: int) -> jnp.ndarray:
    """Zero state batch placed with the batch axis sharded over the mesh."""
    state = jnp.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=jnp.int32)
    return jax.device_put(state, batch_sharding(mesh))


def sharded_transcript_fn(cfg: PoseidonConfig, steps, mesh: Mesh, backend: str = "auto"):
    """Compile a Fiat–Shamir transcript schedule sharded over the mesh.

    The production Fiat–Shamir shape: ``B`` independent transcript lanes (the
    batch axis) advance through one fused absorb/squeeze schedule
    (``sponge_jax.transcript``), each device running the full duplex replay on
    its local ``B/D`` lane slice — zero inter-device communication, since lanes
    are independent sponges.  Input/output contract matches
    ``transcript.compile_transcript``: (total_absorbed, L, B) Montgomery plane
    -> (total_squeezed, L, B) canonical plane, with the batch axis sharded.
    """
    from ..transcript import _replay, transcript_shape

    steps = tuple(steps)
    total_absorbed, _ = transcript_shape(steps)

    def local(elems):
        return _replay(cfg, steps, elems, backend)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, None, DATA_AXIS),
        out_specs=P(None, None, DATA_AXIS),
    )

    @jax.jit
    def run(elems):
        if elems.shape[0] != total_absorbed:
            raise ValueError(
                f"transcript input plane has {elems.shape[0]} element rows; "
                f"the schedule absorbs {total_absorbed}"
            )
        return fn(elems)

    return run
