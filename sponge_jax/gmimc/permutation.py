"""Batched GMiMC-erf permutation over limb-plane state (pure-JAX tier).

Same batched functional shape as the other families: ``state: (t, L, B)
int32 Montgomery limb planes``.  Structure exploitation:

* The whole round is ONE (1, L, B)-plane power map plus a broadcast add
  into the other t-1 branches — no linear layer, no per-branch constants —
  so the per-round device work is the smallest of any shipped family; the
  round COUNT is the largest (hundreds, see params.py), putting GMiMC in
  the same latency-serial regime as Rescue/Griffin/Anemoi.
* The branch rotation is a static concatenation, free at trace time.
* The whole tier runs the **value-safe top-carry rho-folding discipline**
  (``ops.montgomery.fold_norm`` / ``mont_pow_fold``; the Griffin/Poseidon2
  scheme): exact for values up to R at ANY R/p headroom — no per-config
  value-bound gate.  Per-site deferred-limb bounds are noted inline.

This is the family's only device tier (no fused kernel exists for it
yet).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import LIMB_BITS
from ..ops import montgomery as mont
from ..poseidon.permutation import require_xla_backend
from .config import GmimcConfig

_B12 = 1 << LIMB_BITS


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: GmimcConfig):
    """Round constants in device layout: (rounds, L, 1), Montgomery form."""
    fs = cfg.field
    return np.stack(
        [fs.int_to_mont_limbs(c)[:, None] for c in cfg.rc], axis=0
    ).astype(np.int32)


def gmimc_permute(cfg: GmimcConfig, state: jnp.ndarray) -> jnp.ndarray:
    """Full GMiMC-erf permutation on a (t, L, B) Montgomery limb-plane batch.

    Per-site limb bounds feeding the static fold counts: entry planes may
    carry one deferred absorb-add (limbs <= 2^13); inside the loop every
    plane is fold-normalized (limbs <= 2^12), so both add sites (x_0 + c_r
    and x_i + F) defer at most 2 * 2^12 per limb.
    """
    fs = cfg.field
    rc = jnp.asarray(_device_constants(cfg))  # (rounds, L, 1)
    # Montgomery form of 1 (R mod p): mont_mul(x, one_m) = x, reduced < 2p.
    one = jnp.asarray(fs.int_to_limbs(fs.r_mod_p).astype(np.int32))[:, None]

    def round_body(r, st):
        x0 = mont.fold_norm(fs, st[0:1] + rc[r], deferred_limb_bound=2 * _B12)
        f = mont.mont_pow_fold(fs, x0, cfg.alpha)
        rest = mont.fold_norm(fs, st[1:] + f, deferred_limb_bound=2 * _B12)
        # rotate left: the ORIGINAL x_0 (without the constant) moves to the back
        return jnp.concatenate([rest, st[0:1]], axis=0)

    state = mont.fold_norm(fs, state, deferred_limb_bound=2 * _B12)
    state = jax.lax.fori_loop(0, cfg.rounds, round_body, state)
    # One Montgomery-by-1 multiply: x < R strictly => T < R * p => out < 2p —
    # the framework-wide output invariant the sponge's absorb-add relies on.
    return mont.mont_mul(fs, state, one)


@functools.lru_cache(maxsize=None)
def gmimc_permute_jit(cfg: GmimcConfig):
    """Jitted permutation specialized to ``cfg`` (cached per config)."""
    return jax.jit(functools.partial(gmimc_permute, cfg))


def batched_gmimc_permute(cfg: GmimcConfig, state, backend: str = "auto"):
    """Batched GMiMC permutation: the XLA tier on every platform (this family
    has no fused kernel; ``backend`` is "auto" or "xla")."""
    require_xla_backend(backend, "GMiMC")
    return gmimc_permute_jit(cfg)(state)


def zero_state(cfg: GmimcConfig, batch: int) -> jnp.ndarray:
    """Zero-initialized sponge state batch (zero is 0 in Montgomery form)."""
    return jnp.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=jnp.int32)
