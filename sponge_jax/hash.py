"""Fixed-shape Poseidon hashing built on the duplex sponge semantics.

These are the throughput workloads (BASELINE.json configs): batched 2-to-1
compression (one permutation per node — the duplex absorb of [l, r] into a fresh
rate-2 sponge is permutation-free until the squeeze mode flip), fixed-arity
hashing of element blocks, and Merkle tree reduction.  All of them are thin,
jit-friendly wrappers around the batched permutation; outputs are bit-exact with
running the reference sponge absorb/squeeze sequence (tested against the oracle).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ops import montgomery as mont
from .poseidon.config import PoseidonConfig
from .poseidon.permutation import batched_permute


def compress_pairs(
    cfg: PoseidonConfig, left: jnp.ndarray, right: jnp.ndarray, backend: str = "auto"
) -> jnp.ndarray:
    """Batched 2-to-1 compression: (L, B) x (L, B) Montgomery planes -> (L, B).

    Semantics = fresh sponge, absorb([l, r]), squeeze 1 native element
    (state layout capacity‖rate, zero-init, additive absorb — mod.rs:220,128;
    the single permutation happens at the absorb->squeeze mode flip,
    mod.rs:323-329).  Requires rate >= 2.
    """
    if cfg.rate < 2:
        raise ValueError("2-to-1 compression needs rate >= 2")
    L, B = left.shape[-2], left.shape[-1]
    zeros = jnp.zeros((cfg.capacity, L, B), dtype=jnp.int32)
    tail = jnp.zeros((cfg.rate - 2, L, B), dtype=jnp.int32)
    state = jnp.concatenate([zeros, left[None], right[None], tail], axis=0)
    out = batched_permute(cfg, state, backend)
    return out[cfg.capacity]


def hash_elements(
    cfg: PoseidonConfig, elems: jnp.ndarray, num_outputs: int = 1, backend: str = "auto"
) -> jnp.ndarray:
    """Batched fixed-length hash: (k, L, B) Montgomery element plane -> (n, L, B).

    Equivalent to: fresh sponge, absorb the k elements, squeeze ``num_outputs``
    native elements — evaluated with the minimal number of batched permutations
    (the duplex machine permutes every ``rate`` absorbed elements and at the
    squeeze flip; mod.rs:121-150, 321-341).
    """
    k, L, B = elems.shape
    state = jnp.zeros((cfg.t, L, B), dtype=jnp.int32)
    fs = cfg.field
    # absorb_internal chunking: add `rate` elements, permute, repeat; the final
    # (possibly partial) chunk is left unpermuted until the squeeze flip.
    pos = 0
    while True:
        chunk = elems[pos : pos + cfg.rate]
        n = chunk.shape[0]
        if n:
            rows = mont.mont_add(fs, state[cfg.capacity : cfg.capacity + n], chunk)
            state = jnp.concatenate(
                [state[: cfg.capacity], rows, state[cfg.capacity + n :]], axis=0
            )
        pos += n
        if pos >= k:
            break
        state = batched_permute(cfg, state, backend)
    state = batched_permute(cfg, state, backend)  # absorb -> squeeze flip
    # squeeze_internal chunking (mod.rs:153-182).  With rate_start_index = 0
    # (fresh squeeze) the no-permute quirk branch never triggers: every full
    # rate chunk is followed by a permutation.
    outs = []
    remaining = num_outputs
    while True:
        if remaining <= cfg.rate:
            outs.append(state[cfg.capacity : cfg.capacity + remaining])
            break
        outs.append(state[cfg.capacity : cfg.capacity + cfg.rate])
        remaining -= cfg.rate
        state = batched_permute(cfg, state, backend)
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


def merkle_root(
    cfg: PoseidonConfig,
    leaves: jnp.ndarray,
    backend: str = "auto",
    chunk: int = 1 << 17,
) -> jnp.ndarray:
    """Single-device Merkle reduction: (L, N) Montgomery leaf plane -> (L,) root.

    N must be a power of two.  Each tree level is a batched 2-to-1 compression
    over contiguous pairs.  To keep the number of distinct compiled shapes
    constant regardless of depth, wide levels are processed in fixed-size
    ``chunk`` slices and narrow levels are zero-padded up to ``chunk``
    (padding lanes compute a valid all-zero compression and are discarded):
    compile count, not execution, is the XLA tier's cost on the narrow tail
    (at chunk = 2^17 the padding adds ~13% to a 2^24-leaf tree).  See
    ``sponge_jax.parallel.merkle`` for the sharded multi-device version.
    """
    L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    chunk = max(1, min(chunk, N // 2))  # bucket ceiling: the first level's width
    level = leaves
    while level.shape[-1] > 1:
        pairs = level.reshape(L, level.shape[-1] // 2, 2)
        level = _level_compress(cfg, pairs[..., 0], pairs[..., 1], backend, chunk)
    return level[:, 0]


def _level_compress(cfg, l, r, backend, chunk):
    """One tree level through one compiled shape: wide levels are sliced into
    ``chunk`` pieces, narrow levels are padded up to ``chunk`` (padding lanes
    compute a valid all-zero compression and are discarded)."""
    n = l.shape[-1]
    if n > chunk and n % chunk == 0:
        outs = [
            compress_pairs(cfg, l[..., i : i + chunk], r[..., i : i + chunk], backend)
            for i in range(0, n, chunk)
        ]
        return jnp.concatenate(outs, axis=-1)
    if n < chunk:
        widths = [(0, 0), (0, chunk - n)]
        lp, rp = jnp.pad(l, widths), jnp.pad(r, widths)
        return compress_pairs(cfg, lp, rp, backend)[..., :n]
    return compress_pairs(cfg, l, r, backend)


def merkle_tree(
    cfg: PoseidonConfig, leaves: jnp.ndarray, backend: str = "auto", chunk: int = 1 << 17
) -> list:
    """All levels of the Merkle tree, leaves first: [(L, N), (L, N/2), ..., (L, 1)].

    Level i+1[j] = compress(level i[2j], level i[2j+1]).  Needed for producing
    authentication paths; ``merkle_root(...) == merkle_tree(...)[-1][:, 0]``.
    """
    L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    chunk = max(1, min(chunk, N // 2))
    levels = [leaves]
    while levels[-1].shape[-1] > 1:
        cur = levels[-1]
        pairs = cur.reshape(L, cur.shape[-1] // 2, 2)
        levels.append(
            _level_compress(cfg, pairs[..., 0], pairs[..., 1], backend, chunk)
        )
    return levels


def merkle_open(levels: list, index: int) -> list:
    """Authentication path for leaf ``index``: sibling limb columns, bottom-up.

    Returns ``[(L,) sibling at depth 0, ..., (L,) sibling below the root]``.
    """
    n = levels[0].shape[-1]
    if not 0 <= index < n:
        raise IndexError(f"leaf index {index} out of range for {n} leaves")
    path = []
    for level in levels[:-1]:
        path.append(level[:, index ^ 1])
        index >>= 1
    return path


def merkle_open_batch(levels: list, indices) -> jnp.ndarray:
    """Authentication paths for a *batch* of leaf indices, in one device program.

    ``levels`` as returned by ``merkle_tree``; ``indices`` an int sequence or
    (K,) array.  Returns a ``(depth, L, K)`` plane of sibling columns
    (path[d][:, k] = sibling of lane k at depth d) — one fused gather chain
    instead of ``depth`` host-loop reads per proof.
    """
    import numpy as np

    n = levels[0].shape[-1]
    idx_np = np.asarray(indices, dtype=np.int64)
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= n):
        raise IndexError(f"leaf index out of range for {n} leaves")

    @jax.jit
    def gather(levels_t, idx):
        sibs = []
        for level in levels_t:
            sibs.append(jnp.take(level, idx ^ 1, axis=1))
            idx = idx >> 1
        return jnp.stack(sibs, axis=0)

    return gather(tuple(levels[:-1]), jnp.asarray(idx_np, dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("cfg", "backend"))
def _verify_batch_device(cfg, root, leaves, paths, indices, backend):
    fs = cfg.field
    cur = leaves  # (L, K) Montgomery
    idx = indices
    for d in range(paths.shape[0]):
        sib = paths[d]
        is_left = (idx & 1)[None, :] == 0  # lane is the left child
        l = jnp.where(is_left, cur, sib)
        r = jnp.where(is_left, sib, cur)
        cur = compress_pairs(cfg, l, r, backend)
        idx = idx >> 1
    # Canonical comparison (redundant-limb representations of equal values
    # compare equal after from_mont's canonicalization).
    got = mont.from_mont(fs, cur)
    want = mont.from_mont(fs, root[:, None])
    return jnp.all(got == want, axis=0)


def merkle_verify_batch(
    cfg: PoseidonConfig,
    root: jnp.ndarray,
    leaves: jnp.ndarray,
    paths: jnp.ndarray,
    indices,
    backend: str = "auto",
) -> jnp.ndarray:
    """Verify K proofs in ONE fused device program (depth batched compressions).

    ``root``: (L,); ``leaves``: (L, K) Montgomery columns; ``paths``:
    (depth, L, K) as from ``merkle_open_batch``; ``indices``: (K,) ints.
    Returns a (K,) bool array.  Replaces the one-dispatch-per-level pattern:
    a 2^24-leaf proof batch costs 24 batched permutations total, not 24*K
    single-lane calls.
    """
    import numpy as np

    depth = paths.shape[0]
    idx_np = np.asarray(indices, dtype=np.int64)
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= (1 << depth)):
        raise IndexError(f"leaf index out of range for path depth {depth}")
    return _verify_batch_device(
        cfg, root, leaves, paths, jnp.asarray(idx_np, dtype=jnp.int32), backend
    )


def merkle_verify(
    cfg: PoseidonConfig,
    root: jnp.ndarray,
    leaf: jnp.ndarray,
    path: list,
    index: int,
    backend: str = "auto",
) -> bool:
    """Recompute the root from one leaf + authentication path and compare.

    ``root``/``leaf``/path entries are (L,) Montgomery limb columns (as produced
    by merkle_tree/merkle_open).  Single-proof convenience wrapper over
    ``merkle_verify_batch`` — one fused device program, not one dispatch per
    tree level.
    """
    import numpy as np

    if not 0 <= index < (1 << len(path)):
        raise IndexError(f"leaf index {index} out of range for path depth {len(path)}")
    paths = jnp.stack([s[:, None] for s in path], axis=0)  # (depth, L, 1)
    out = merkle_verify_batch(
        cfg,
        root,
        leaf[:, None],
        paths,
        [index],
        backend="xla" if backend == "auto" else backend,
    )
    return bool(np.asarray(out)[0])


# ---------------------------------------------------------------------------
# Wide digests: Merkle trees whose nodes are d-element digests.
#
# Over ~255-bit fields a single element is a 255-bit digest and d = 1 (the
# functions above).  Over small fields one element is NOT collision-resistant
# (a 64-bit Goldilocks digest gives 32-bit security); the standard construction
# (plonky2-family) uses d = 4 elements (256 digest bits).  With rate >= 2d a
# 2-to-1 digest compression is still exactly ONE permutation: absorb the 2d
# concatenated elements (no permute until the mode flip), squeeze d.
# ---------------------------------------------------------------------------


def default_digest_elems(cfg: PoseidonConfig) -> int:
    """Elements per Merkle digest for ~128-bit collision resistance:
    ceil(256 / field bits) — 1 for the 255-bit fields, 4 for Goldilocks."""
    return max(1, -(-256 // cfg.field.modulus_bit_size))


def compress_digest_pairs(
    cfg: PoseidonConfig, left: jnp.ndarray, right: jnp.ndarray, backend: str = "auto"
) -> jnp.ndarray:
    """Batched 2-to-1 digest compression: (d, L, B) x (d, L, B) -> (d, L, B).

    Semantics = fresh sponge, absorb the 2d concatenated elements, squeeze d —
    i.e. ``hash_elements`` on the pair; one permutation when 2d <= rate
    (the Goldilocks default: d = 4, rate = 8), the duplex chunking otherwise.
    ``compress_pairs`` is the d = 1 special case.
    """
    d = left.shape[0]
    return hash_elements(
        cfg, jnp.concatenate([left, right], axis=0), num_outputs=d, backend=backend
    )


def _level_compress_wide(cfg, level, backend, chunk, compress=None):
    """One wide-digest tree level through a constant set of compiled kernel
    shapes (``compress`` defaults to the sponge-mode digest compression; the
    Jive mode threads its own)."""
    compress = compress or compress_digest_pairs
    d, L, n2 = level.shape
    pairs = level.reshape(d, L, n2 // 2, 2)
    l, r = pairs[..., 0], pairs[..., 1]
    n = l.shape[-1]
    if n > chunk and n % chunk == 0:
        return jnp.concatenate(
            [
                compress(cfg, l[..., i : i + chunk], r[..., i : i + chunk], backend)
                for i in range(0, n, chunk)
            ],
            axis=-1,
        )
    if n < chunk:
        widths = [(0, 0), (0, 0), (0, chunk - n)]
        lp, rp = jnp.pad(l, widths), jnp.pad(r, widths)
        return compress(cfg, lp, rp, backend)[..., :n]
    return compress(cfg, l, r, backend)


def merkle_tree_wide(
    cfg: PoseidonConfig,
    leaves: jnp.ndarray,
    backend: str = "auto",
    chunk: int = 1 << 17,
) -> list:
    """All levels of a wide-digest Merkle tree, leaves first.

    ``leaves``: (d, L, N) Montgomery digest plane, N a power of two.  Returns
    [(d, L, N), (d, L, N/2), ..., (d, L, 1)].
    """
    d, L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    chunk = max(1, min(chunk, N // 2))
    levels = [leaves]
    while levels[-1].shape[-1] > 1:
        levels.append(_level_compress_wide(cfg, levels[-1], backend, chunk))
    return levels


def merkle_root_wide(
    cfg: PoseidonConfig,
    leaves: jnp.ndarray,
    backend: str = "auto",
    chunk: int = 1 << 17,
) -> jnp.ndarray:
    """(d, L, N) digest plane -> (d, L) root (see ``merkle_tree_wide``)."""
    level = leaves
    d, L, N = level.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    chunk = max(1, min(chunk, N // 2))
    while level.shape[-1] > 1:
        level = _level_compress_wide(cfg, level, backend, chunk)
    return level[..., 0]


def merkle_open_batch_wide(levels: list, indices) -> jnp.ndarray:
    """Authentication paths for K leaves of a wide tree, one device program.

    Returns a ``(depth, d, L, K)`` plane of sibling digests.
    """
    import numpy as np

    n = levels[0].shape[-1]
    idx_np = np.asarray(indices, dtype=np.int64)
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= n):
        raise IndexError(f"leaf index out of range for {n} leaves")

    @jax.jit
    def gather(levels_t, idx):
        sibs = []
        for level in levels_t:
            sibs.append(jnp.take(level, idx ^ 1, axis=2))
            idx = idx >> 1
        return jnp.stack(sibs, axis=0)

    return gather(tuple(levels[:-1]), jnp.asarray(idx_np, dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("cfg", "backend", "compress"))
def _verify_batch_wide_device(cfg, root, leaves, paths, indices, backend,
                              compress=None):
    compress = compress or compress_digest_pairs
    fs = cfg.field
    cur = leaves  # (d, L, K)
    idx = indices
    for lvl in range(paths.shape[0]):
        sib = paths[lvl]
        is_left = (idx & 1)[None, None, :] == 0
        l = jnp.where(is_left, cur, sib)
        r = jnp.where(is_left, sib, cur)
        cur = compress(cfg, l, r, backend)
        idx = idx >> 1
    got = mont.from_mont(fs, cur)
    want = mont.from_mont(fs, root[..., None])
    return jnp.all(got == want, axis=(0, 1))


def merkle_verify_batch_wide(
    cfg: PoseidonConfig,
    root: jnp.ndarray,
    leaves: jnp.ndarray,
    paths: jnp.ndarray,
    indices,
    backend: str = "auto",
) -> jnp.ndarray:
    """Verify K wide-digest proofs in one fused device program.

    ``root``: (d, L); ``leaves``: (d, L, K); ``paths``: (depth, d, L, K) as
    from ``merkle_open_batch_wide``; ``indices``: (K,) ints -> (K,) bools.
    """
    import numpy as np

    depth = paths.shape[0]
    idx_np = np.asarray(indices, dtype=np.int64)
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= (1 << depth)):
        raise IndexError(f"leaf index out of range for path depth {depth}")
    return _verify_batch_wide_device(
        cfg, root, leaves, paths, jnp.asarray(idx_np, dtype=jnp.int32), backend
    )


# ---------------------------------------------------------------------------
# Jive compression mode (the Anemoi paper's Merkle construction, ePrint
# 2022/840 §4): a b-to-1 PERMUTATION-mode compression with a feed-forward
# sum instead of a sponge capacity — Jive_2 maps the full t-element state to
# t/2 digest elements with exactly one permutation and no capacity overhead,
# so a t = 2 permutation (Anemoi's Jive width) compresses two 255-bit
# digests in one call.  Works over ANY even-width family config via the
# batched_permute dispatch hook.
# ---------------------------------------------------------------------------


def jive_compress_pairs(
    cfg, left: jnp.ndarray, right: jnp.ndarray, backend: str = "auto"
) -> jnp.ndarray:
    """Batched Jive_2 compression: (d, L, B) x (d, L, B) -> (d, L, B), d = t/2.

    digest_j = x_j + x_{d+j} + P(x)_j + P(x)_{d+j}  (feed-forward sum over
    the two input blocks).  Inputs/outputs are Montgomery limb planes
    honoring the framework-wide value < 2p invariant (the 4-term sum is
    reduced back below 2p by one Montgomery-by-1 multiply: the sum value is
    < 8p << R, so T/R + p < 2p at every shipped R/p headroom).
    """
    d = left.shape[0]
    if cfg.t != 2 * d:
        raise ValueError(
            f"Jive_2 needs t = 2 * digest width; got t={cfg.t}, d={d}"
        )
    fs = cfg.field
    x = jnp.concatenate([left, right], axis=0)  # (t, L, B)
    px = batched_permute(cfg, x, backend)
    acc = mont.mont_add(fs, x[:d], x[d:], px[:d], px[d:])
    one = jnp.asarray(
        fs.int_to_limbs(fs.r_mod_p).astype("int32")
    )[:, None]
    return mont.mont_mul(fs, acc, one)


def merkle_root_jive(
    cfg,
    leaves: jnp.ndarray,
    backend: str = "auto",
    chunk: int = 1 << 17,
) -> jnp.ndarray:
    """Jive-mode Merkle reduction: (d, L, N) digest plane -> (d, L) root,
    d = t/2 (one permutation per node; cf. ``merkle_root_wide`` for the
    sponge-mode construction).  N must be a power of two.
    """
    d, L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    chunk = max(1, min(chunk, N // 2))
    level = leaves
    while level.shape[-1] > 1:
        level = _level_compress_wide(
            cfg, level, backend, chunk, compress=jive_compress_pairs
        )
    return level[..., 0]


def merkle_tree_jive(
    cfg,
    leaves: jnp.ndarray,
    backend: str = "auto",
    chunk: int = 1 << 17,
) -> list:
    """All levels of a Jive-mode Merkle tree, leaves first.

    ``leaves``: (d, L, N) Montgomery digest plane, d = t/2, N a power of two.
    Returns [(d, L, N), ..., (d, L, 1)]; open proofs with
    ``merkle_open_batch_wide`` (level-indexed, compression-agnostic) and
    check them with ``merkle_verify_batch_jive``.
    """
    d, L, N = leaves.shape
    if N & (N - 1):
        raise ValueError("leaf count must be a power of two")
    chunk = max(1, min(chunk, N // 2))
    levels = [leaves]
    while levels[-1].shape[-1] > 1:
        levels.append(
            _level_compress_wide(
                cfg, levels[-1], backend, chunk, compress=jive_compress_pairs
            )
        )
    return levels


def merkle_verify_batch_jive(
    cfg,
    root: jnp.ndarray,
    leaves: jnp.ndarray,
    paths: jnp.ndarray,
    indices,
    backend: str = "auto",
) -> jnp.ndarray:
    """Verify K Jive-mode proofs in one fused device program.

    Same shapes as ``merkle_verify_batch_wide`` (root (d, L), leaves
    (d, L, K), paths (depth, d, L, K) from ``merkle_open_batch_wide``),
    recomputed with the Jive_2 feed-forward compression instead of the
    sponge-mode digest compression.
    """
    import numpy as np

    depth = paths.shape[0]
    idx_np = np.asarray(indices, dtype=np.int64)
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= (1 << depth)):
        raise IndexError(f"leaf index out of range for path depth {depth}")
    return _verify_batch_wide_device(
        cfg, root, leaves, paths, jnp.asarray(idx_np, dtype=jnp.int32), backend,
        compress=jive_compress_pairs,
    )
