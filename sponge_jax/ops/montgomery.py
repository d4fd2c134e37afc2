"""Batched Montgomery field arithmetic over int32 limb planes (pure JAX tier).

Replacement for the scalar Montgomery arithmetic the reference sponge
inherits from ark-ff (field mul/add/pow call sites at
the reference's src/poseidon/mod.rs:63-93).  Everything here is element-wise int32
work over arrays of shape ``(..., L, B)``:

* limb axis (``L = fs.nlimbs``, 12-bit limbs) second to last,
* batch axis ``B`` last, so one vector instruction advances many sponges at once.

Design invariant (enforced in ``FieldSpec.__post_init__``): all limbs are kept
``<= 2**12`` (redundant form), so schoolbook partial products are ``<= 2**24`` and all
column accumulations incl. Montgomery reduction stay ``< 2**31`` — plain int32, no
hi/lo splitting, wrap-around free.  Values are only canonicalized (unique repr < p)
at API output boundaries.

These functions are the device tier of every permutation family, on every
platform.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..fields import LIMB_BITS, LIMB_MASK, FieldSpec


def _const_col(fs: FieldSpec, value: int) -> np.ndarray:
    """(L, 1) int32 broadcastable constant column for ``value`` (plain limbs)."""
    return fs.int_to_limbs(value)[:, None].astype(np.int32)


@functools.lru_cache(maxsize=None)
def field_consts(fs: FieldSpec):
    """Cached numpy constants used by the kernels: (p_limbs, r2_mont, one_plain)."""
    nprime = (-pow(fs.modulus, -1, fs.r)) % fs.r  # -p^{-1} mod R (full width)
    return {
        "p": _const_col(fs, fs.modulus),
        "r2": _const_col(fs, fs.r2_mod_p),
        "one": _const_col(fs, 1),
        "nprime": _const_col(fs, nprime),
    }


def carry_pass(x: jnp.ndarray, lb: int = LIMB_BITS) -> jnp.ndarray:
    """One vectorized carry-propagation pass along the limb axis (-2).

    The carry popped off the top limb is dropped; callers must guarantee by bound
    analysis that the total value fits in L limbs (true everywhere below because
    Montgomery outputs are < p + 1 << R).
    """
    c = x >> lb
    x = x & ((1 << lb) - 1)
    c = jnp.concatenate([jnp.zeros_like(c[..., :1, :]), c[..., :-1, :]], axis=-2)
    return x + c


def normalize(x: jnp.ndarray, passes: int, lb: int = LIMB_BITS) -> jnp.ndarray:
    """Apply ``passes`` carry passes; the needed count comes from bound analysis.

    After a Montgomery multiply limbs are < L * (2^lb)^2 (~2^29.2 at the 12-bit
    plan, ~2^30.4 at the 13-bit plan — int32-safe in both, because this
    non-interleaved tier normalizes between REDC steps): three passes restore
    the ``<= 2^lb`` redundant invariant exactly (each pass divides the residual
    carry by 2^lb).
    """
    for _ in range(passes):
        x = carry_pass(x, lb)
    return x


def _pad_limbs(x: jnp.ndarray, before: int, after: int) -> jnp.ndarray:
    """Zero-pad along the limb axis (-2) with static amounts (compiles to concat)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(before, after), (0, 0)]
    return jnp.pad(x, pad)


def _limb(b, j: int):
    """j-th limb of operand ``b``: a broadcastable slice for arrays, a python-int
    immediate for static tuples (zero limbs return 0 so the term can be elided)."""
    if isinstance(b, tuple):
        return b[j]
    return b[..., j : j + 1, :]


def _school_full(L: int, a: jnp.ndarray, b) -> jnp.ndarray:
    """Full schoolbook product into 2L redundant columns: t[k] = sum_{i+j=k} a_i b_j.

    Expressed as L statically-padded shifted rank-1 updates summed in one tree —
    no dynamic-update-slices, so XLA traces/fuses it cheaply.  Columns < 2^29 for
    limbs <= 2^12.  ``b`` may be a limb-plane array or a static tuple of ints
    (constant operand; zero limbs are skipped).
    """
    terms = [
        _pad_limbs(a * bj, j, L - j)
        for j in range(L)
        for bj in [_limb(b, j)]
        if not (isinstance(bj, int) and bj == 0)
    ]
    return _tree_sum(terms) if terms else jnp.zeros(a.shape[:-2] + (2 * L,) + a.shape[-1:], a.dtype)


def _school_low(L: int, a: jnp.ndarray, b) -> jnp.ndarray:
    """Low half of the schoolbook product (columns 0..L-1 only)."""
    terms = [
        _pad_limbs(a[..., : L - j, :] * bj, j, 0)
        for j in range(L)
        for bj in [_limb(b, j)]
        if not (isinstance(bj, int) and bj == 0)
    ]
    return _tree_sum(terms) if terms else jnp.zeros_like(a)


def _tree_sum(terms):
    """Pairwise-tree sum of a term list.

    Avoids ``jnp.stack`` (which materializes an (L, ..., 2L, B) temporary — at
    B = 2^17 that is ~0.5 GB per product and collapses throughput to HBM
    bandwidth) while keeping the reduction depth logarithmic.
    """
    while len(terms) > 1:
        nxt = [
            terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
            for i in range(0, len(terms), 2)
        ]
        terms = nxt
    return terms[0]


def mont_mul(
    fs: FieldSpec,
    a: jnp.ndarray,
    b: jnp.ndarray,
    p: Optional[jnp.ndarray] = None,
    nprime: Optional[jnp.ndarray] = None,
    final_norm=None,
) -> jnp.ndarray:
    """Batched Montgomery product ``a * b * R^{-1}`` over (..., L, B) limb planes.

    Non-interleaved REDC, chosen because every step is a fully parallel schoolbook
    product (static pads + tree sums — tiny traced graph, no sequential
    dynamic-slice chains):

        T  = a * b                          (2L redundant columns)
        m  = (T mod R) * N' mod R           (N' = -p^{-1} mod R, precomputed limbs)
        S  = T + m * p                      (divisible by R by construction)
        r  = S / R                          (high half + exact low-half carry)

    The only sequential piece is the L-step scalar carry chain computing the exact
    carry of S's low half into limb L.  Inputs: redundant limbs <= 2^12; output:
    same invariant, value < 2p (the redundant-m excess adds < p/4096).

    ``p``/``nprime`` (each (L, 1) canonical limb columns) default to cached host
    constants; inside a Pallas kernel they must be passed explicitly (Pallas
    forbids captured array constants).
    """
    L = fs.nlimbs
    if p is None or nprime is None:
        consts = field_consts(fs)
        p = jnp.asarray(consts["p"])            # (L, 1) canonical limbs
        nprime = jnp.asarray(consts["nprime"])  # (L, 1) limbs of -p^{-1} mod R

    lb = fs.limb_bits
    # T = a*b, normalized back to <= 2^lb limbs (3 passes; bound analysis in
    # ``normalize``).  Top-limb carries cannot occur: value < p^2 << R^2.
    t = normalize(_school_full(L, a, b), passes=3, lb=lb)
    t_lo, t_hi = t[..., :L, :], t[..., L:, :]

    # m ≡ T * N' (mod R): low-half product, carries above limb L-1 intentionally
    # dropped (that *is* the mod R), renormalized for the next product.
    m = normalize(_school_low(L, t_lo, nprime), passes=3, lb=lb)

    # S = T + m*p.  S ≡ 0 (mod R), so the exact low-half carry chain terminates
    # with S_lo / R, which is added at limb position L.
    mp = _school_full(L, m, p)
    s_lo = t_lo + mp[..., :L, :]
    s_hi = t_hi + mp[..., L:, :]

    c = jnp.zeros_like(s_lo[..., 0, :])
    for k in range(L):
        c = (s_lo[..., k, :] + c) >> lb
    # r[0] += c, expressed as slice+concat (scatter-add does not lower in Pallas).
    r = jnp.concatenate(
        [s_hi[..., :1, :] + c[..., None, :], s_hi[..., 1:, :]], axis=-2
    )
    # ``final_norm`` overrides the closing normalization.  The default 3-pass
    # carry_pass chain drops the top carry, which is sound only while the
    # result value (< T/R + p) provably stays below R — true for the < 4p
    # value discipline of the Poseidon tiers; value-safe callers
    # (mont_mul_fold) substitute a rho-folding norm instead.
    if final_norm is not None:
        return final_norm(r)
    return normalize(r, passes=3, lb=lb)


def mont_add(fs: FieldSpec, *xs: jnp.ndarray) -> jnp.ndarray:
    """Field addition of up to ~64 operands without modular reduction.

    Reduction is deferred: values remain correct mod p and limbs return to the
    <= 2^12 redundant invariant after two carry passes (sums of k <= 64 limbs are
    < 2^18, one pass leaves < 2^12 + 2^6, second pass < 2^12 + 1).
    Matches the additive absorb/ARK semantics of the reference
    (/root/reference/src/poseidon/mod.rs:76-80,128).
    """
    assert len(xs) >= 2 and len(xs) <= 64
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return normalize(acc, passes=2, lb=fs.limb_bits)


def mont_pow(
    fs: FieldSpec,
    x: jnp.ndarray,
    alpha: int,
    p: Optional[jnp.ndarray] = None,
    nprime: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """x^alpha via MSB-first square-and-multiply (static chain, unrolled at trace).

    For the reference S-box exponents this costs: alpha=5 -> 2 sq + 1 mul,
    alpha=17 -> 4 sq + 1 mul, alpha=257 -> 8 sq + 1 mul
    (cf. /root/reference/src/poseidon/mod.rs:63-74).
    """
    assert alpha >= 1
    bits = bin(alpha)[2:]
    acc = x
    for bit in bits[1:]:
        acc = mont_mul(fs, acc, acc, p, nprime)
        if bit == "1":
            acc = mont_mul(fs, acc, x, p, nprime)
    return acc


def to_mont(fs: FieldSpec, x_plain: jnp.ndarray) -> jnp.ndarray:
    """Plain (canonical-integer) limbs -> Montgomery form, on device."""
    r2 = jnp.asarray(field_consts(fs)["r2"])
    # r2 is stored as plain limbs of R^2 mod p; mont_mul(x, R^2) = x*R.
    return mont_mul(fs, x_plain, r2)


def from_mont(fs: FieldSpec, x_mont: jnp.ndarray) -> jnp.ndarray:
    """Montgomery form -> canonical plain limbs (unique representative < p)."""
    one = jnp.asarray(field_consts(fs)["one"])
    r = mont_mul(fs, x_mont, one)          # value < 2p, limbs <= 2^12
    return canonicalize(fs, r)


def canonicalize(fs: FieldSpec, x: jnp.ndarray) -> jnp.ndarray:
    """Exact sequential carry + single conditional subtract of p.

    Only used at output boundaries (squeeze); the hot loop never calls this.
    Requires the input value to be < 2p (true for ``from_mont`` results).
    """
    L = fs.nlimbs
    p = jnp.asarray(field_consts(fs)["p"])

    # Exact carry chain -> unique limb decomposition of the (possibly = p) value.
    lb = fs.limb_bits
    mask = (1 << lb) - 1
    c = jnp.zeros_like(x[..., 0, :])
    outs = []
    for k in range(L):
        v = x[..., k, :] + c
        outs.append(v & mask)
        c = v >> lb
    y = jnp.stack(outs, axis=-2)

    # Conditional subtraction: z = y - p with a sequential borrow chain.
    borrow = jnp.zeros_like(c)
    zs = []
    for k in range(L):
        d = y[..., k, :] - p[k, 0] - borrow
        zs.append(d & mask)
        borrow = (d >> lb) & 1      # 1 iff d was negative (arith shift)
    z = jnp.stack(zs, axis=-2)
    ge_p = (borrow == 0)[..., None, :]     # no final borrow <=> y >= p
    return jnp.where(ge_p, z, y)


# ----------------------------------------------------------------------------------
# Slow-but-obviously-correct oracle tier (python ints; test-only, never on device).
# ----------------------------------------------------------------------------------


class OracleField:
    """Python-int field arithmetic: the test oracle for every kernel above.

    Mirrors ark-ff semantics exactly (mod-p canonical values); used by the oracle
    sponge in ``sponge_jax.poseidon.oracle`` and by kernel equivalence tests.
    """

    def __init__(self, fs: FieldSpec):
        self.fs = fs
        self.p = fs.modulus

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        return pow(a, -1, self.p)

    def neg(self, a: int) -> int:
        return (-a) % self.p


# ----------------------------------------------------------------------------------
# Top-carry rho-folding (value-safe normalization for ANY R/p headroom).
#
# carry_pass drops the carry popped off the top limb — sound only while values
# provably stay below R = 2^(12L).  Schedules whose linear layers never
# Montgomery-reduce (Poseidon2) or whose row sums approach R/p (wide states
# over small fields) instead use fold_norm: an exact sequential carry pass
# whose final carry c is folded back as c * rho with rho = R mod p — exact
# mod p, since 2^(12L) ≡ rho.  Fold counts are static, derived from exact
# python-int value bounds.
# ----------------------------------------------------------------------------------


def _exact_pass(x: jnp.ndarray, lb: int = LIMB_BITS):
    """One exact sequential carry pass along the limb axis.

    Returns (limbs <= 2^lb - 1, top_carry) — nothing is dropped; the caller
    folds or proves the top carry zero."""
    mask = (1 << lb) - 1
    L = x.shape[-2]
    c = jnp.zeros_like(x[..., 0, :])
    outs = []
    for k in range(L):
        v = x[..., k, :] + c
        outs.append(v & mask)
        c = v >> lb
    return jnp.stack(outs, axis=-2), c


def fold_count(R: int, rho: int, vmax: int) -> int:
    """Folds guaranteeing value < R from the exclusive value bound ``vmax``
    """
    folds = 0
    while vmax > R:
        cm = (vmax - 1) // R
        cand = cm * rho + (vmax - 1 - cm * R)
        if cm >= 1:
            cand = max(cand, (cm - 1) * rho + (R - 1))
        vmax = cand + 1
        folds += 1
        if folds > 16:
            raise AssertionError("rho-folding does not converge; bad field spec")
    return folds


@functools.lru_cache(maxsize=None)
def _rho_col(fs: FieldSpec) -> "np.ndarray":
    return fs.int_to_limbs(fs.r % fs.modulus).astype(np.int32)[:, None]


def fold_norm(
    fs: FieldSpec,
    x: jnp.ndarray,
    deferred_limb_bound: int = 0,
    vmax: int = 0,
) -> jnp.ndarray:
    """Exact normalization of a deferred limb plane with statically-counted
    top-carry rho-folds: output limbs <= 2^12, value < R, exact mod p.

    Give either ``deferred_limb_bound`` (inclusive bound on the input limbs,
    e.g. row_sum * 2^12 after an un-reduced linear layer — the value bound is
    derived from it) or an explicit exclusive value bound ``vmax`` when a
    tighter one is known.  Cost: (folds + 1) exact sequential carry passes —
    the value-safe replacement for ``normalize`` wherever values may reach R.
    """
    R, p = fs.r, fs.modulus
    rho = R % p
    if not vmax:
        assert deferred_limb_bound > 0
        vmax = deferred_limb_bound * ((R - 1) // fs.limb_mask) + 1
    folds = fold_count(R, rho, vmax)
    rho_col = jnp.asarray(_rho_col(fs))
    for _ in range(folds):
        x, c = _exact_pass(x, fs.limb_bits)
        x = x + c[..., None, :] * rho_col
    out, _c = _exact_pass(x, fs.limb_bits)  # top carry provably zero
    return out


def mont_mul_fold(fs: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``mont_mul`` whose closing normalization rho-folds: value-safe for
    ANY inputs with values < R (the plain tail drops a top carry when
    T/R + p >= R).  Output: limbs <= 2^12, value < R, exact mod p."""
    # T < R^2 strictly (inputs < R strictly), so the result value is
    # < T/R + p < R + p: one fold suffices.
    return mont_mul(
        fs, a, b,
        final_norm=lambda r: fold_norm(fs, r, vmax=fs.r + fs.modulus + 1),
    )


def mont_pow_fold(fs: FieldSpec, x: jnp.ndarray, alpha: int) -> jnp.ndarray:
    """x^alpha via square-and-multiply over ``mont_mul_fold`` (value-safe)."""
    assert alpha >= 1
    bits = bin(alpha)[2:]
    acc = x
    for bit in bits[1:]:
        acc = mont_mul_fold(fs, acc, acc)
        if bit == "1":
            acc = mont_mul_fold(fs, acc, x)
    return acc


