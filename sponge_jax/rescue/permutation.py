"""Batched Rescue-Prime permutation over limb-plane state (pure-JAX tier).

Same batched functional shape as the Poseidon XLA tier
(``poseidon.permutation``): ``state: (t, L, B) int32 Montgomery limb planes``.
The Rescue-specific part is the inverse S-box x^(1/alpha): a ~log2(p)-bit
fixed exponent, evaluated with a **fixed-window ladder** (static 4-bit
digits, 16-entry power table, ``fori_loop`` over digits) — ~log2(p)
squarings + ~log2(p)/4 table multiplies, vs 2*log2(p) products for the
select-every-bit ladder it replaced, while keeping the traced graph to one
small loop body (see ``_pow_ladder``).

This is the family's only device tier (no fused kernel exists for it
yet).  Rescue's throughput deficit vs Poseidon (~2 * ceil(log2 p) muls per
element-round vs ~4) is intrinsic to the family's design either way — it
exists to be cheap in-circuit, not forward.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import montgomery as mont
from ..poseidon.permutation import require_xla_backend
from .config import RescueConfig


@functools.lru_cache(maxsize=None)
def check_rescue_value_bounds(cfg: RescueConfig) -> None:
    """Statically simulate worst-case VALUES through one Rescue round.

    Same discipline as the Poseidon XLA tier's gate
    (``poseidon.permutation.check_value_bounds``): Montgomery products are
    self-reducing, but the un-reduced t-term MDS sum plus the constant add
    must stay below R for ``carry_pass`` to be sound.  Raises for unsafe
    (field, t) combinations; every shipped default passes.
    """
    fs = cfg.field
    p, R = fs.modulus, fs.r
    t = cfg.t

    def mul(a: int, b: int) -> int:
        if a >= R or b >= R:
            raise ValueError(
                f"Rescue XLA-tier value bound reaches R for t={t} over "
                f"{fs.name} (R/p headroom too small for this width)"
            )
        return (a * b) // R + p + 1

    def ladder_bound(v: int, exponent: int) -> int:
        # Models both mont_pow (squarings + multiplies by x) and the
        # fixed-window ladder (squaring runs + multiplies by table entries,
        # where each table entry is an x^k chain bounded by the
        # multiply-by-x fixpoint).  Bounds converge after a couple of
        # iterations; iterate a few steps past convergence.
        tb = v  # table-entry bound: fixpoint of z -> mul(z, v)
        for _ in range(8):
            tb = max(tb, mul(tb, v))
        acc = v
        for _ in range(6):
            acc = mul(acc, acc)
            acc = max(acc, mul(acc, tb))
        return acc

    V = p  # canonical inputs
    for _ in range(cfg.rounds + 2):  # iterate to the round-to-round fixpoint
        V = ladder_bound(V, cfg.alpha)
        V = t * mul(V, p) + p  # MDS row sum (t reduced products) + rc add
        if V >= R:
            mul(R, R)  # raise with the standard message
        V = ladder_bound(V, cfg.inv_alpha)
        V = t * mul(V, p) + p
        if V >= R:
            mul(R, R)


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: RescueConfig):
    """Constants in device layout: rc (2N, t, L, 1) and mds (t, t, L, 1),
    both Montgomery-form (same domain discipline as poseidon.config
    .device_constants)."""
    fs = cfg.field
    rc = np.stack(
        [np.stack([fs.int_to_mont_limbs(c) for c in row], axis=0) for row in cfg.rc],
        axis=0,
    ).astype(np.int32)[..., None]
    mds = np.stack(
        [np.stack([fs.int_to_mont_limbs(c) for c in row], axis=0) for row in cfg.mds],
        axis=0,
    ).astype(np.int32)[..., None]
    return rc, mds


_WINDOW_BITS = 4


def pow_ladder(
    fs, x: jnp.ndarray, exponent: int, value_safe: bool = False
) -> jnp.ndarray:
    """x^exponent on Montgomery planes via a fixed-window ladder.

    For small exponents (the forward S-box) the unrolled chain in
    ``mont.mont_pow`` is already minimal.  For the ~log2(p)-bit inverse
    exponent, the exponent is split into static 4-bit digits (MSB-first,
    computed at trace time): a 16-entry power table ``x^0..x^15`` is built
    once (14 multiplies), then a ``fori_loop`` over digits runs 4 squarings
    + one table-gather multiply per digit.  Cost: ~log2(p) squarings +
    ~log2(p)/4 multiplies (+14 table builds) — ~1.55x fewer Montgomery
    products than the select-every-bit ladder it replaced — while the traced
    graph stays one small loop body (an unrolled chain of ~300 multiplies
    pushed XLA compile time past 10 minutes on CPU).

    ``value_safe=True`` routes every product through the top-carry
    rho-folding multiply (``mont.mont_mul_fold``), making the ladder exact
    for inputs with values up to R at any R/p headroom (the discipline the
    Griffin tier uses); the default plain multiply relies on the caller's
    < 4p value bound (Rescue's gate, ``check_rescue_value_bounds``).
    """
    mul = mont.mont_mul_fold if value_safe else mont.mont_mul
    bits = bin(exponent)[2:]
    if len(bits) <= 12:
        return (mont.mont_pow_fold if value_safe else mont.mont_pow)(
            fs, x, exponent
        )
    w = _WINDOW_BITS
    pad = (-len(bits)) % w
    bits = "0" * pad + bits
    digits_host = [int(bits[i : i + w], 2) for i in range(0, len(bits), w)]
    digits = jnp.asarray(digits_host, dtype=jnp.int32)
    one = jnp.broadcast_to(
        jnp.asarray(fs.int_to_mont_limbs(1).astype(np.int32))[None, :, None],
        x.shape,
    )
    entries = [one, x]
    for _ in range(2, 1 << w):
        entries.append(mul(fs, entries[-1], x))
    table = jnp.stack(entries, axis=0)  # (16, t, L, B)

    def body(i, acc):
        for _ in range(w):
            acc = mul(fs, acc, acc)
        entry = jax.lax.dynamic_index_in_dim(table, digits[i], 0, keepdims=False)
        return mul(fs, acc, entry)

    return jax.lax.fori_loop(1, len(digits_host), body, table[digits_host[0]])


# Backwards-compatible private alias (pre-Griffin name).
_pow_ladder = pow_ladder


def _mds_rc(fs, mds, state, rc_row):
    """MDS matrix-vector product + constant injection on (t, L, B) planes.

    ``mont_add`` normalizes internally (2 carry passes), which restores the
    limb invariant after the t-term un-reduced sum (t * 2^12 + 2^12 < 2^17
    per limb for every shipped width)."""
    prod = mont.mont_mul(fs, mds, state[None])  # (t, t, L, B)
    return mont.mont_add(fs, jnp.sum(prod, axis=1), rc_row)


def rescue_permute(cfg: RescueConfig, state: jnp.ndarray) -> jnp.ndarray:
    """Full Rescue-Prime permutation on a (t, L, B) Montgomery state batch."""
    check_rescue_value_bounds(cfg)
    fs = cfg.field
    rc_np, mds_np = _device_constants(cfg)
    rc = jnp.asarray(rc_np)  # (2N, t, L, 1)
    mds = jnp.asarray(mds_np)  # (t, t, L, 1)
    inv_alpha = cfg.inv_alpha

    def round_body(r, st):
        st = pow_ladder(fs, st, cfg.alpha)
        st = _mds_rc(fs, mds, st, rc[2 * r])
        st = pow_ladder(fs, st, inv_alpha)
        return _mds_rc(fs, mds, st, rc[2 * r + 1])

    return jax.lax.fori_loop(0, cfg.rounds, round_body, state)


@functools.lru_cache(maxsize=None)
def rescue_permute_jit(cfg: RescueConfig):
    """Jitted permutation specialized to ``cfg`` (cached per config)."""
    return jax.jit(functools.partial(rescue_permute, cfg))


def batched_rescue_permute(cfg: RescueConfig, state, backend: str = "auto"):
    """Batched Rescue permutation: the XLA tier on every platform (this family
    has no fused kernel; ``backend`` is "auto" or "xla")."""
    require_xla_backend(backend, "Rescue")
    return rescue_permute_jit(cfg)(state)


def zero_state(cfg: RescueConfig, batch: int) -> jnp.ndarray:
    """Zero-initialized sponge state batch (zero is 0 in Montgomery form)."""
    return jnp.zeros((cfg.t, cfg.field.nlimbs, batch), dtype=jnp.int32)
