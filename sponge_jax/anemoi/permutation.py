"""Batched Anemoi permutation over limb-plane state (pure-JAX tier).

Same batched functional shape as the other families: ``state: (t, L, B)
int32 Montgomery limb planes`` with the Anemoi columns as the two halves
(X = state[:l], Y = state[l:]).  Structure exploitation:

* All l Flystel pairs advance TOGETHER: the expensive x^(1/alpha) ladder
  runs once per round over the whole (l, L, B) X-column plane, so widening
  the state costs almost nothing extra in ladder latency.
* Subtractions (the limb planes are unsigned-redundant) become one
  Montgomery multiply by a negated constant: -g*y^2 is a single
  ``mont_mul_fold`` by (-g), and the dynamic subtrahends (the ladder
  output, in v = y - u^(1/alpha)) negate via one multiply by
  Montgomery(-1).
* The whole tier runs the **value-safe top-carry rho-folding discipline**
  (``ops.montgomery.fold_norm`` / ``mont_mul_fold``, the Griffin/Poseidon2
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
from ..rescue.permutation import pow_ladder
from .config import AnemoiConfig

_B12 = 1 << LIMB_BITS


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: AnemoiConfig):
    """Constants in device layout (numpy, Montgomery form): rc planes
    (rounds, l, L, 1), the mat_x entry columns, and the Flystel scalars
    (g, -g, -(g^-1), -1) as (L, 1) limb columns."""
    fs = cfg.field
    p = fs.modulus

    def rc_plane(rows):
        return np.stack(
            [
                np.stack([fs.int_to_mont_limbs(c) for c in row], axis=0)
                for row in rows
            ],
            axis=0,
        ).astype(np.int32)[..., None]

    def col(v):
        return fs.int_to_mont_limbs(v % p).astype(np.int32)[:, None]

    mat = tuple(tuple(col(e) for e in row) for row in cfg.mat_x)
    return {
        "rc_x": rc_plane(cfg.rc_x),
        "rc_y": rc_plane(cfg.rc_y),
        "mat": mat,
        "g": col(cfg.g),
        "neg_g": col(-cfg.g),
        "neg_ginv": col(-cfg.g_inv),
        "neg_one": col(-1),
        "one": fs.int_to_limbs(fs.r_mod_p).astype(np.int32)[:, None],
    }


def anemoi_permute(cfg: AnemoiConfig, state: jnp.ndarray) -> jnp.ndarray:
    """Full Anemoi permutation on a (t, L, B) Montgomery limb-plane batch."""
    fs = cfg.field
    lcol = cfg.l
    c = _device_constants(cfg)
    rc_x = jnp.asarray(c["rc_x"])  # (rounds, l, L, 1)
    rc_y = jnp.asarray(c["rc_y"])
    mat = [[jnp.asarray(e) for e in row] for row in c["mat"]]
    g = jnp.asarray(c["g"])
    neg_g = jnp.asarray(c["neg_g"])
    neg_ginv = jnp.asarray(c["neg_ginv"])
    neg_one = jnp.asarray(c["neg_one"])
    one = jnp.asarray(c["one"])
    inv_alpha = cfg.inv_alpha
    identity_mat = lcol == 1  # PHT alone diffuses a single pair

    def mat_apply(col_plane):
        """M_x . column on (l, L, B) planes: l Montgomery products per output
        row, canonical-limb terms summed deferred (limbs <= l * 2^12)."""
        if identity_mat:
            return col_plane
        rows = []
        for i in range(lcol):
            acc = None
            for j in range(lcol):
                term = mont.mont_mul_fold(fs, col_plane[j : j + 1], mat[i][j])
                acc = term if acc is None else acc + term
            rows.append(acc)
        return mont.fold_norm(
            fs, jnp.concatenate(rows, axis=0), deferred_limb_bound=lcol * _B12
        )

    def diffusion(xs, ys):
        """M_x on X, M_x on rot-left-1(Y), then the PHT (config docstring)."""
        xs = mat_apply(xs)
        ys = mat_apply(jnp.roll(ys, -1, axis=0) if lcol > 1 else ys)
        ys = mont.fold_norm(fs, ys + xs, deferred_limb_bound=2 * _B12)
        xs = mont.fold_norm(fs, xs + ys, deferred_limb_bound=2 * _B12)
        return xs, ys

    def flystel(xs, ys):
        """Open Flystel on all l pairs at once (see anemoi/config.py)."""
        # u = x - (g*y^2 + g^-1): one multiply by (-g) plus a constant add.
        sq = mont.mont_mul_fold(fs, ys, ys)
        u = mont.fold_norm(
            fs,
            xs + mont.mont_mul_fold(fs, sq, neg_g) + neg_ginv,
            deferred_limb_bound=3 * _B12,
        )
        # v = y - u^(1/alpha): the ladder output negates via one multiply.
        lad = pow_ladder(fs, u, inv_alpha, value_safe=True)
        v = mont.fold_norm(
            fs,
            ys + mont.mont_mul_fold(fs, lad, neg_one),
            deferred_limb_bound=2 * _B12,
        )
        # w = u + g*v^2.
        w = mont.fold_norm(
            fs,
            u + mont.mont_mul_fold(fs, mont.mont_mul_fold(fs, v, v), g),
            deferred_limb_bound=2 * _B12,
        )
        return w, v

    def round_body(r, st):
        xs = mont.fold_norm(
            fs, st[:lcol] + rc_x[r], deferred_limb_bound=2 * _B12
        )
        ys = mont.fold_norm(
            fs, st[lcol:] + rc_y[r], deferred_limb_bound=2 * _B12
        )
        xs, ys = diffusion(xs, ys)
        xs, ys = flystel(xs, ys)
        return jnp.concatenate([xs, ys], axis=0)

    state = jax.lax.fori_loop(0, cfg.rounds, round_body, state)
    xs, ys = diffusion(state[:lcol], state[lcol:])  # closing linear layer
    # One Montgomery-by-1 multiply (1 in Montgomery form): value < R strictly
    # => out < 2p — the framework-wide output invariant.
    return mont.mont_mul(fs, jnp.concatenate([xs, ys], axis=0), one)


@functools.lru_cache(maxsize=None)
def anemoi_permute_jit(cfg: AnemoiConfig):
    """Jitted permutation specialized to ``cfg`` (cached per config)."""
    return jax.jit(functools.partial(anemoi_permute, cfg))


def batched_anemoi_permute(cfg: AnemoiConfig, state, backend: str = "auto"):
    """Batched Anemoi permutation: the XLA tier on every platform (this family
    has no fused kernel; ``backend`` is "auto" or "xla")."""
    require_xla_backend(backend, "Anemoi")
    return anemoi_permute_jit(cfg)(state)


def zero_state(cfg: AnemoiConfig, batch: int) -> jnp.ndarray:
    """Zero-initialized sponge state batch (zero is 0 in Montgomery form)."""
    return jnp.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=jnp.int32)
