"""Batched Griffin-pi permutation over limb-plane state (pure-JAX tier).

Same batched functional shape as the other families: ``state: (t, L, B)
int32 Montgomery limb planes``.  Structure exploitation:

* The linear layer is Poseidon2's small-integer matrix family — a plain
  ``tensordot`` scaling of limb planes with NO Montgomery reduction; the
  deferred limbs are cleared by the next fold-normalization.
* The expensive inverse power map x^(1/d) applies to ONE state element per
  round (vs Rescue's whole state), so Griffin's forward cost per round is
  ~1 wide ladder + 1 short power chain + (t-2) quadratic-gate multiplies —
  the cheapest wide-exponent family shipped.
* The whole tier runs the **value-safe top-carry rho-folding discipline**
  (``ops.montgomery.fold_norm`` / ``mont_mul_fold``; same scheme as the
  Poseidon2 XLA tier): every product is exact for values up to R at ANY
  R/p headroom, so no per-config value-bound gate is needed — fold counts
  are static, derived from the documented per-site limb bounds below.

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
from ..rescue.permutation import pow_ladder
from .config import GriffinConfig

_B12 = 1 << LIMB_BITS


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: GriffinConfig):
    """Constants in device layout (numpy, Montgomery form):

    * ``rc``: (rounds, t, L, 1) — the rounds-1 constant rows plus a zero row
      for the last round, so the round loop stays uniform (adding the zero
      limb plane is the identity);
    * ``mat_e``: (t, t) small plain ints;
    * ``quads``: per i in 2..t-1, the (alpha_i, beta_i) Montgomery limb
      columns (L, 1).
    """
    fs = cfg.field
    t = cfg.t
    zero_row = tuple(0 for _ in range(t))
    rc = np.stack(
        [
            np.stack([fs.int_to_mont_limbs(c) for c in row], axis=0)
            for row in tuple(cfg.rc) + (zero_row,)
        ],
        axis=0,
    ).astype(np.int32)[..., None]
    mat_e = np.asarray(cfg.mat_e, dtype=np.int32)
    quads = []
    for i in range(2, t):
        a_i, b_i = cfg.quad_coeffs(i)
        quads.append(
            (
                fs.int_to_mont_limbs(a_i).astype(np.int32)[:, None],
                fs.int_to_mont_limbs(b_i).astype(np.int32)[:, None],
            )
        )
    return rc, mat_e, tuple(quads)


def griffin_permute(cfg: GriffinConfig, state: jnp.ndarray) -> jnp.ndarray:
    """Full Griffin-pi permutation on a (t, L, B) Montgomery limb-plane batch.

    Per-site limb bounds feeding the static fold counts (inputs to every
    site are fold-normalized: limbs <= 2^12, values < R):

    * linear layer: tensordot leaves limbs <= row_sum * 2^12 (row_sum <= 24
      for every defined width: int32-exact), + 2^12 for the constant add;
    * L_i combination: (i-1)*y0 + y1 + x_{i-1} leaves limbs <= (i+1) * 2^12;
    * quadratic gate: sq + alpha_i*L_i (both mont_mul_fold outputs,
      canonical limbs) + beta_i (canonical) leaves limbs <= 3 * 2^12.
    """
    fs = cfg.field
    t = cfg.t
    rc_np, mat_np, quads_np = _device_constants(cfg)
    rc = jnp.asarray(rc_np)  # (rounds, t, L, 1)
    mat_e = jnp.asarray(mat_np)  # (t, t)
    quads = [(jnp.asarray(a), jnp.asarray(b)) for a, b in quads_np]
    # Montgomery form of 1 (R mod p): mont_mul(x, one_m) = x, reduced < 2p.
    one = jnp.asarray(fs.int_to_limbs(fs.r_mod_p).astype(np.int32))[:, None]
    row_sum = max(sum(row) for row in cfg.mat_e)
    d_rc = row_sum * _B12 + _B12
    inv_alpha = cfg.inv_alpha

    def apply_mat(st):
        """out_i = sum_j e_ij * x_j — plain-int scaling, left deferred."""
        return jnp.tensordot(mat_e, st, axes=1)

    def nonlinear(st):
        y0 = pow_ladder(fs, st[0:1], inv_alpha, value_safe=True)
        y1 = mont.mont_pow_fold(fs, st[1:2], cfg.alpha)
        outs = [y0, y1]
        for i in range(2, t):
            li = (i - 1) * y0 + y1
            if i >= 3:
                li = li + st[i - 1 : i]
            li = mont.fold_norm(fs, li, deferred_limb_bound=(i + 1) * _B12)
            a_i, b_i = quads[i - 2]
            sq = mont.mont_mul_fold(fs, li, li)
            al = mont.mont_mul_fold(fs, li, a_i)
            quad = mont.fold_norm(fs, sq + al + b_i, deferred_limb_bound=3 * _B12)
            outs.append(mont.mont_mul_fold(fs, st[i : i + 1], quad))
        return jnp.concatenate(outs, axis=0)

    def round_body(r, st):
        st = nonlinear(st)
        st = mont.fold_norm(fs, apply_mat(st) + rc[r], deferred_limb_bound=d_rc)
        return st

    state = mont.fold_norm(
        fs, apply_mat(state), deferred_limb_bound=row_sum * _B12
    )
    state = jax.lax.fori_loop(0, cfg.rounds, round_body, state)
    # One Montgomery-by-1 multiply (1 in Montgomery form, i.e. R mod p):
    # x < R strictly => T < R * p => out < 2p — the framework-wide output
    # invariant the sponge's absorb-add and from_mont rely on.
    return mont.mont_mul(fs, state, one)


@functools.lru_cache(maxsize=None)
def griffin_permute_jit(cfg: GriffinConfig):
    """Jitted permutation specialized to ``cfg`` (cached per config)."""
    return jax.jit(functools.partial(griffin_permute, cfg))


def batched_griffin_permute(cfg: GriffinConfig, state, backend: str = "auto"):
    """Batched Griffin permutation: the XLA tier on every platform (this family
    has no fused kernel; ``backend`` is "auto" or "xla")."""
    require_xla_backend(backend, "Griffin")
    return griffin_permute_jit(cfg)(state)


def zero_state(cfg: GriffinConfig, batch: int) -> jnp.ndarray:
    """Zero-initialized sponge state batch (zero is 0 in Montgomery form)."""
    return jnp.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=jnp.int32)
