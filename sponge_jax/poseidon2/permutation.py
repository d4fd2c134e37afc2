"""Batched Poseidon2 permutation over limb-plane state (XLA tier).

Structure exploitation: the external matrix M_E multiplies the
state only by SMALL plain integers (entries <= 14 for every defined width),
and scaling a Montgomery-form limb plane by a plain integer is just
``c * x`` followed by carry handling — no REDC.  The internal layer
``M_I = J + diag(mu - 1)`` is one shared row sum plus a per-element
diagonal product.

**Value-growth discipline.**  Poseidon2's linear layers never Montgomery-
reduce, so element VALUES (not just limbs) grow by the matrix row sums and
would overflow the L-limb window (values live mod R = 2^(12 L);
``montgomery.carry_pass`` drops top carries by design).  This tier uses
**top-carry rho-folding** via the exact-sequential ``montgomery.fold_norm`` /
``mont_mul_fold`` / ``mont_pow_fold`` helpers:

* linear-layer outputs stay *deferred* (un-normalized limb sums) and are
  folded by the next round's constant-add normalization — fold counts are
  static, from exact python-int bounds;
* S-box chains run through ``mont_mul_fold`` (their tails can reach R + p);
* the permutation closes with one Montgomery-by-1 multiply restoring the
  framework-wide ``value < 2p`` output invariant.

This makes the tier exact for EVERY (field, width) combination — including
minimum-headroom fields (R/p = 16) at wide states, where the row sums exceed
R within a single round — at the cost of a few exact sequential carry passes
per round.  It is the family's only device tier (no fused kernel exists
for it yet).

State layout matches Poseidon: (t, L, B) int32 Montgomery limb planes;
permutation outputs satisfy the framework-wide value < 2p invariant.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import LIMB_BITS
from ..ops import montgomery as mont
from ..poseidon.permutation import require_xla_backend
from .config import Poseidon2Config


@functools.lru_cache(maxsize=None)
def device_constants2(cfg: Poseidon2Config):
    """Round constants / matrix data in device layout (numpy)."""
    fs = cfg.field
    ext = np.stack(
        [
            np.stack([fs.int_to_mont_limbs(c) for c in row], axis=0)
            for row in cfg.external_rc
        ],
        axis=0,
    ).astype(np.int32)[..., None]  # (R_F, t, L, 1)
    if cfg.partial_rounds:
        internal = np.stack(
            [fs.int_to_mont_limbs(c) for c in cfg.internal_rc], axis=0
        ).astype(np.int32)[..., None]  # (R_P, L, 1)
    else:
        internal = np.zeros((0, fs.nlimbs, 1), dtype=np.int32)
    mat_e = np.asarray(cfg.mat_e, dtype=np.int32)  # (t, t) small ints
    diag_m1 = np.stack(
        [fs.int_to_mont_limbs((d - 1) % fs.modulus) for d in cfg.mat_i_diag],
        axis=0,
    ).astype(np.int32)[..., None]  # (t, L, 1) Montgomery form
    return {"ext": ext, "internal": internal, "mat_e": mat_e, "diag_m1": diag_m1}


def poseidon2_permute(cfg: Poseidon2Config, state: jnp.ndarray) -> jnp.ndarray:
    """Full Poseidon2 permutation on a (t, L, B) Montgomery limb-plane batch."""
    fs = cfg.field
    t = cfg.t
    consts = device_constants2(cfg)
    ext = jnp.asarray(consts["ext"])  # (R_F, t, L, 1)
    internal = jnp.asarray(consts["internal"])  # (R_P, L, 1)
    mat_e = jnp.asarray(consts["mat_e"])  # (t, t)
    diag_m1 = jnp.asarray(consts["diag_m1"])  # (t, L, 1)
    # Montgomery form of 1 (R mod p): mont_mul(x, one_m) = x, reduced < 2p.
    one = jnp.asarray(fs.int_to_limbs(fs.r_mod_p).astype(np.int32))[:, None]
    half = cfg.full_rounds // 2

    # Static deferred-limb bounds per fold site:
    B12 = 1 << LIMB_BITS
    row_sum = max(sum(row) for row in cfg.mat_e)
    d_ext = row_sum * B12          # un-reduced M_E output limbs
    d_int = (1 + t) * B12          # diagonal product (canonical) + row sum
    d_rc = max(d_ext, d_int) + B12  # + one constant add

    def apply_mat_e(st):
        """out_i = sum_j e_ij * x_j — plain-int scaling, left deferred
        (limbs <= row_sum * 2^12 < 2^21 — int32-exact); the consumer's
        fold_norm clears it."""
        return jnp.tensordot(mat_e, st, axes=1)

    def external_round(r, st):
        st = mont.fold_norm(fs, st + ext[r], d_rc)
        st = mont.mont_pow_fold(fs, st, cfg.alpha)
        return apply_mat_e(st)

    def internal_round(r, st):
        # Constant-add on element 0 only; the fold-norm clears the previous
        # round's deferred linear-layer limbs for ALL elements.
        st = jnp.concatenate([st[:1] + internal[r][None], st[1:]], axis=0)
        st = mont.fold_norm(fs, st, d_rc)
        s0 = mont.mont_pow_fold(fs, st[0], cfg.alpha)
        st = jnp.concatenate([s0[None], st[1:]], axis=0)
        # M_I = J + diag(mu-1): shared row sum (deferred, <= t * 2^12 limbs)
        # + per-element diagonal product (fold-reduced, canonical).
        sigma = jnp.sum(st, axis=0)
        prod = mont.mont_mul_fold(fs, st, diag_m1)
        return prod + sigma[None]

    state = apply_mat_e(state)  # initial linear layer (deferred)
    state = jax.lax.fori_loop(0, half, external_round, state)
    state = jax.lax.fori_loop(0, cfg.partial_rounds, internal_round, state)
    state = jax.lax.fori_loop(half, cfg.full_rounds, external_round, state)
    # Clear the last deferred layer, then one Montgomery-by-1 multiply:
    # x < R strictly => T < R * p => out < 2p (the framework-wide output
    # invariant the sponge's absorb-add and from_mont rely on).
    state = mont.fold_norm(fs, state, d_ext)
    return mont.mont_mul(fs, state, one)


@functools.lru_cache(maxsize=None)
def poseidon2_permute_jit(cfg: Poseidon2Config):
    return jax.jit(functools.partial(poseidon2_permute, cfg))


def batched_permute2(cfg: Poseidon2Config, state, backend: str = "auto"):
    """Batched Poseidon2 permutation: the XLA tier on every platform (this family
    has no fused kernel; ``backend`` is "auto" or "xla")."""
    require_xla_backend(backend, "Poseidon2")
    return poseidon2_permute_jit(cfg)(state)