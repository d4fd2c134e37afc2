"""Sharded Merkle-tree reduction over a device mesh.

The BASELINE.json headline distributed workload: 2-to-1 Poseidon compression over
2^24 leaves, layer by layer.  Design (SURVEY.md §5.7, §7.3 item 4):

* Leaves are laid out ``(L, N)`` with the leaf axis sharded over the 1-D ``data``
  mesh in contiguous chunks, so every tree level pairs *adjacent* nodes locally —
  zero communication while the level is wide.
* Each wide level runs inside ``shard_map``: per-device ``compress_pairs`` over
  the local chunk.
* When a level becomes too narrow to shard (fewer than ``2 * n_devices`` nodes —
  the reshard-when-narrow cutover), the remainder is all-gathered once
  and finished replicated on every device (cheaper than repeatedly rebalancing a
  shrinking tail; the tail is O(n_devices) work).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..hash import compress_pairs, merkle_root
from ..poseidon.config import PoseidonConfig
from .mesh import DATA_AXIS, leaf_sharding


def _bucketed_wide_phase(level, layer, D, chunk_local):
    """Run the wide (sharded) tree phase through a constant set of compiled
    ``shard_map`` programs.

    Each narrow level's per-device width is padded up to ``chunk_local``
    (compile time dominates there, and one shared program beats log2(N)
    per-width compiles).  Padding lanes sit at
    the END of the global lane axis, so under the contiguous-chunk sharding the
    real pairs are exactly the first n/2 outputs — slice and continue.  Padding
    lanes compute a valid all-zero compression and are discarded."""
    chunk_local = max(2, min(chunk_local, level.shape[-1] // D))
    while level.shape[-1] >= 2 * D and level.shape[-1] > 1:
        n = level.shape[-1]
        n_local = n // D
        tgt_local = max(n_local, chunk_local)
        pad = tgt_local * D - n
        if pad:
            widths = [(0, 0)] * (level.ndim - 1) + [(0, pad)]
            level = jnp.pad(level, widths)
        level = layer(level)[..., : n // 2]
    return level


def sharded_merkle_root(
    cfg: PoseidonConfig,
    leaves: jnp.ndarray,
    mesh: Mesh,
    backend: str = "auto",
) -> jnp.ndarray:
    """(L, N) Montgomery leaf plane sharded over ``mesh`` -> (L,) root.

    N must be a power of two and divisible by the mesh size while the tree is
    wide; the narrow tail switches to a replicated single-device reduction after
    one all-gather.
    """
    L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    D = mesh.devices.size

    def local_layer(chunk):
        # chunk: (L, N_local) — pair adjacent nodes and compress, fully local.
        n = chunk.shape[-1]
        pairs = chunk.reshape(L, n // 2, 2)
        return compress_pairs(cfg, pairs[..., 0], pairs[..., 1], backend)

    # jit-wrapped: bare shard_map calls re-trace and re-compile on EVERY
    # invocation even at identical shapes; under jit the per-shape executable
    # is cached, so the bucketed wide phase really does compile once.
    layer = jax.jit(
        shard_map(
            local_layer,
            mesh=mesh,
            in_specs=P(None, DATA_AXIS),
            out_specs=P(None, DATA_AXIS),
        )
    )

    level = jax.device_put(leaves, leaf_sharding(mesh))
    # Wide phase: every level halves; stop once pairs would straddle shards.
    # Levels are padded to shared bucket shapes so the phase compiles a
    # constant number of programs regardless of depth (_bucketed_wide_phase).
    level = _bucketed_wide_phase(level, layer, D, 1 << 17)

    # Narrow tail: one gather, then finish replicated (O(D) nodes left).
    if level.shape[-1] > 1:
        level = jax.device_put(level, NamedSharding(mesh, P()))
        level = merkle_root(cfg, level, backend="xla")[:, None]
    return level[:, 0]


def sharded_merkle_verify_batch(
    cfg: PoseidonConfig,
    root: jnp.ndarray,
    leaves: jnp.ndarray,
    paths: jnp.ndarray,
    indices,
    mesh: Mesh,
    backend: str = "auto",
) -> jnp.ndarray:
    """``hash.merkle_verify_batch`` with the K proof-lane axis sharded.

    Proof lanes are independent (each recomputes its own root from leaf +
    sibling path), so verification is embarrassingly parallel over the mesh:
    ``root`` is replicated, ``leaves`` (L, K) / ``paths`` (depth, L, K) /
    ``indices`` (K,) split their lane axis, and each device runs the fused
    depth-batched compression chain on its local K/D slice — no communication.
    K must be divisible by the mesh size.
    """
    import numpy as np

    from ..hash import _verify_batch_device

    depth = paths.shape[0]
    idx_np = np.asarray(indices, dtype=np.int64)
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= (1 << depth)):
        raise IndexError(f"leaf index out of range for path depth {depth}")

    def local(root_rep, leaves_c, paths_c, idx_c):
        return _verify_batch_device(
            cfg, root_rep, leaves_c, paths_c, idx_c, backend
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None), P(None, DATA_AXIS), P(None, None, DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
    )
    return jax.jit(fn)(
        root, leaves, paths, jnp.asarray(idx_np, dtype=jnp.int32)
    )


def sharded_merkle_root_wide(
    cfg: PoseidonConfig,
    leaves: jnp.ndarray,
    mesh: Mesh,
    backend: str = "auto",
    compress=None,
) -> jnp.ndarray:
    """Wide-digest variant: (d, L, N) digest plane sharded over ``mesh`` ->
    (d, L) root.  Same contiguous-pair layout and reshard-at-narrow cutover as
    ``sharded_merkle_root``; each node is a d-element digest (see
    ``hash.merkle_root_wide`` — the security-correct shape for small fields).
    ``compress`` swaps the per-node compression (sponge-mode digest
    compression by default; ``sharded_merkle_root_jive`` threads the Jive_2
    feed-forward)."""
    from ..hash import compress_digest_pairs, merkle_root_wide

    compress = compress or compress_digest_pairs
    d, L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    D = mesh.devices.size

    def local_layer(chunk):
        n = chunk.shape[-1]
        pairs = chunk.reshape(d, L, n // 2, 2)
        return compress(cfg, pairs[..., 0], pairs[..., 1], backend)

    layer = jax.jit(
        shard_map(
            local_layer,
            mesh=mesh,
            in_specs=P(None, None, DATA_AXIS),
            out_specs=P(None, None, DATA_AXIS),
        )
    )

    level = jax.device_put(
        leaves, NamedSharding(mesh, P(None, None, DATA_AXIS))
    )
    level = _bucketed_wide_phase(level, layer, D, 1 << 17)

    if level.shape[-1] > 1:
        level = jax.device_put(level, NamedSharding(mesh, P()))
        return _narrow_tail_root(cfg, level, compress)
    return level[..., 0]


def _narrow_tail_root(cfg, level, compress):
    """Finish a narrow (< 2 per device) replicated level; batches this small
    never tile, so the tail always runs the XLA backend (as before).  The
    bucket chunk is capped at the tail's own width so every tail level shares
    one compiled shape."""
    from ..hash import _level_compress_wide

    chunk = max(1, level.shape[-1] // 2)
    while level.shape[-1] > 1:
        level = _level_compress_wide(
            cfg, level, "xla", chunk, compress=compress
        )
    return level[..., 0]


def sharded_merkle_root_jive(
    cfg,
    leaves: jnp.ndarray,
    mesh: Mesh,
    backend: str = "auto",
) -> jnp.ndarray:
    """Jive-mode sharded Merkle root: (d, L, N) digest plane, d = t/2, one
    permutation per node with the ePrint 2022/840 §4 feed-forward sum (see
    ``hash.merkle_root_jive``); same mesh layout and narrow-tail cutover as
    ``sharded_merkle_root_wide``."""
    from ..hash import jive_compress_pairs

    return sharded_merkle_root_wide(
        cfg, leaves, mesh, backend, compress=jive_compress_pairs
    )
