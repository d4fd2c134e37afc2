"""Batched Poseidon permutation over limb-plane state: XLA tier + dispatch.

The reference hot loop (the reference's poseidon/mod.rs:95-118) is a scalar
in-place state machine; here it is re-architected as a batched functional
transform

    state: (t, L, B) int32 Montgomery limb planes  ->  same shape

advancing B independent sponge states per call.  Round structure:
``R_F/2`` full rounds, ``R_P`` partial rounds (S-box on state element 0 only,
mod.rs:72), ``R_F/2`` full rounds; each round is ARK add -> S-box x^alpha -> dense
t x t MDS matrix-vector product, all expressed through the int32 Montgomery kernels
in ``sponge_jax.ops.montgomery``.

Each phase is a ``lax.fori_loop`` with the round constants gathered
dynamically from a stacked (R, t, L, 1) array, keeping the traced graph to
two round bodies.  This tier is the device path on every platform (the GPU
included; docs/DESIGN.md "GPU bring-up" records why no fused kernel runs
there yet), and ``batched_permute`` is the one dispatch point every caller
goes through.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import montgomery as mont
from .config import PoseidonConfig, device_constants


@functools.lru_cache(maxsize=None)
def check_value_bounds(cfg: PoseidonConfig) -> bool:
    """Statically simulate worst-case VALUES through the XLA-tier round.

    The fast tier's value discipline is self-reducing (every round ends in
    Montgomery-reduced MDS products), but the un-reduced MDS *sum* is bounded
    by t * (V p / R + p) and the next constant add by + p — for wide states
    over minimum-headroom fields, or for low-degree S-boxes whose single
    squaring contracts too little per round (e.g. KoalaBear's alpha = 3 at
    t = 16, R/p = 32), the round-to-round fixpoint diverges and reaches R,
    where ``carry_pass`` silently drops a top carry.  Returns True when the
    fast discipline is safe; False routes ``permute`` to the value-safe
    rho-folding round (``_round_fold``) — exact for ANY (field, t, alpha),
    a few exact carry passes slower.  (The Poseidon2 XLA tier always
    rho-folds and needs no check.)
    """
    fs = cfg.field
    p, R = fs.modulus, fs.r
    t = cfg.t

    class _Overflow(Exception):
        pass

    def mul(a: int, b: int) -> int:
        if a >= R or b >= R:
            raise _Overflow
        return (a * b) // R + p + 1

    def sbox(v: int) -> int:
        acc = v
        for bit in bin(cfg.alpha)[2:][1:]:
            acc = mul(acc, acc)
            if bit == "1":
                acc = mul(acc, v)
        return acc

    try:
        V = p  # canonical inputs
        for _ in range(cfg.rounds + 2):  # iterate past the round count to fixpoint
            V = V + p  # ark add
            V = sbox(V)
            V = t * mul(V, p)  # MDS row: t reduced products, un-reduced sum
            if V >= R:
                raise _Overflow
    except _Overflow:
        return False
    return True


def _round(cfg, ark_r, mds, state, full: bool):
    """One Poseidon round on (t, L, B) state. ``ark_r``: (t, L, 1); ``mds``: (t, t, L, 1)."""
    fs = cfg.field
    # ARK: additive round keys (mod.rs:76-80).
    state = mont.mont_add(fs, state, ark_r)
    # S-box (mod.rs:63-74): full -> all elements; partial -> element 0 only.
    if full:
        state = mont.mont_pow(fs, state, cfg.alpha)
    else:
        s0 = mont.mont_pow(fs, state[0], cfg.alpha)
        state = jnp.concatenate([s0[None], state[1:]], axis=0)
    # MDS: new[i] = sum_j mds[i][j] * state[j] (mod.rs:82-93), vectorized as ONE
    # batched Montgomery product over the whole (t, t) matrix followed by a
    # limb-wise sum over j (valid pre-normalization: t*2^12 column sums stay far
    # below the int32 bound; two carry passes restore the limb invariant).
    prod = mont.mont_mul(fs, mds, state[None])          # (t, t, L, B)
    return mont.normalize(jnp.sum(prod, axis=1), passes=2, lb=fs.limb_bits)


def _round_fold(cfg, ark_r, mds, state, full: bool):
    """Value-safe variant of ``_round``: every step rho-folds, so values stay
    < R exactly for ANY (field, t, alpha) — used when ``check_value_bounds``
    detects that the fast discipline's round fixpoint would reach R (e.g.
    alpha = 3 over a 31-bit field at t = 16, where one squaring per S-box
    contracts too little).  Invariant: state enters and leaves each round
    with limbs <= 2^12 and value < R."""
    fs = cfg.field
    # Lazy ARK add (limbs <= 2*LIMB_MASK, value < R + p), then one fold.
    state = mont.fold_norm(fs, state + ark_r, vmax=fs.r + fs.modulus)
    if full:
        state = mont.mont_pow_fold(fs, state, cfg.alpha)
    else:
        s0 = mont.mont_pow_fold(fs, state[0], cfg.alpha)
        state = jnp.concatenate([s0[None], state[1:]], axis=0)
    prod = mont.mont_mul_fold(fs, mds, state[None])     # values < R, limbs <= 2^12
    return mont.fold_norm(
        fs, jnp.sum(prod, axis=1), deferred_limb_bound=cfg.t * fs.limb_mask
    )


def permute(cfg: PoseidonConfig, state: jnp.ndarray) -> jnp.ndarray:
    """Full Poseidon permutation on a (t, L, B) Montgomery limb-plane state batch."""
    # lru-cached static simulation: fast discipline vs value-safe folding round
    round_fn = _round if check_value_bounds(cfg) else _round_fold
    consts = device_constants(cfg)
    ark = jnp.asarray(consts["ark"])  # (R, t, L, 1)
    mds = jnp.asarray(consts["mds"])  # (t, t, L, 1)
    half_full = cfg.full_rounds // 2

    def full_body(r, st):
        return round_fn(cfg, ark[r], mds, st, full=True)

    def partial_body(r, st):
        return round_fn(cfg, ark[r], mds, st, full=False)

    # Three phases, each a fori_loop with the round constants gathered by round
    # index — keeps the traced graph to two round bodies regardless of R_F/R_P.
    state = jax.lax.fori_loop(0, half_full, full_body, state)
    state = jax.lax.fori_loop(
        half_full, half_full + cfg.partial_rounds, partial_body, state
    )
    state = jax.lax.fori_loop(
        half_full + cfg.partial_rounds, cfg.rounds, full_body, state
    )
    return state


@functools.lru_cache(maxsize=None)
def permute_jit(cfg: PoseidonConfig):
    """Jitted permutation specialized to ``cfg`` (cached per config)."""
    return jax.jit(functools.partial(permute, cfg))


def require_xla_backend(backend: str, family: str) -> None:
    """Backend check: every family runs its XLA tier, named "auto" or "xla"."""
    if backend not in ("auto", "xla"):
        raise ValueError(
            f"unknown backend {backend!r} for {family}: use 'auto' or 'xla'"
        )


def batched_permute(cfg: PoseidonConfig, state: jnp.ndarray, backend: str = "auto"):
    """Batched permutation of a (t, L, B) state through the XLA tier.

    Other permutation families (e.g. Poseidon2) plug into the same duplex
    sponge by providing a ``batched_permute`` hook on their config type;
    everything above the permutation (sponge, transcripts, Merkle,
    checkpointing) is config-agnostic.
    """
    if not isinstance(cfg, PoseidonConfig):
        return cfg.batched_permute(state, backend)
    require_xla_backend(backend, "Poseidon")
    return permute_jit(cfg)(state)


def zero_state(cfg: PoseidonConfig, batch: int) -> jnp.ndarray:
    """Zero-initialized sponge state batch (mod.rs:220); zero is 0 in Montgomery form."""
    return jnp.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=jnp.int32)
