"""Batched Monolith permutation over limb-plane state (XLA tier).

Structure exploitation (ePrint 2023/1025 structure, re-designed
for int32 limb planes — see docs/DESIGN.md):

* **Bars** are pure bitwise integer work: the element is brought to canonical
  bits (one Montgomery-by-1 multiply + exact canonicalization), statically
  re-sliced from 12-bit limbs into the (8, 8, ..., rem) bar chunks, passed
  through the chi-like S-box as ~8 int32 ops per chunk (no tables, no
  gathers), re-sliced back, and returned to Montgomery form (one multiply by
  R^2).  2 multiplies per barred element per round is the entire domain-
  crossing cost.
* **Bricks** (x_i += x_{i-1}^2) are t-1 batched Montgomery squarings — the
  only full-width multiplies of a round.
* **Concrete**: when the matrix is a power-of-two circulant (the Goldilocks
  t = 12 instance) the matmul is **multiplication-free**: each term is a
  static limb-axis shift (exponent // 12 positions) plus an in-limb scale by
  2^(exponent % 12), tree-summed in a widened (L + E)-limb plane and folded
  back exactly with the rho = R mod p identity.  Dense matrices (the Cauchy
  31-bit instances) run the same batched-Montgomery product the Poseidon MDS
  uses.

Value discipline: rho-folding everywhere (``montgomery.fold_norm`` /
``mont_mul_fold``), with static python-int bounds at every site — exact for
any bar-safe (field, t) combination.  State layout matches Poseidon:
(t, L, B) int32 Montgomery limb planes; inputs may carry any value < R;
outputs satisfy the framework-wide value < 2p invariant.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import LIMB_BITS, LIMB_MASK
from ..ops import montgomery as mont
from ..ops.montgomery import _school_low, _tree_sum  # shared limb kernels
from ..poseidon.permutation import require_xla_backend
from .config import MonolithConfig, bar_chunks


@functools.lru_cache(maxsize=None)
def scaled_concrete_geometry(cfg: MonolithConfig):
    """Static geometry of the multiplication-free scaled-Concrete path, or
    None when the matrix must take the dense Montgomery path.

    The path applies when every matrix entry is a small plain integer
    (< 2^24): each entry decomposes into at most two 12-bit limb digits
    ``c = sum_d m_d * 2^(12 q_d)``, so a term is just ``x * m_d`` placed at
    limb offset ``q_d`` — no REDC anywhere in the linear layer.  Terms
    accumulate in a widened (L + E)-limb plane; the high limbs fold back
    through rho = R mod p.  Geometry checks:

    * widened plane holds the worst value: row_sum * R < 2^(12 (L+E));
    * int32 column budget: <= 2t digit-products of < 2^24 per column;
    * the hi * rho fold's schoolbook columns stay inside L limbs.
    """
    mat = cfg.concrete_small_entries()
    if mat is None:
        return None
    fs = cfg.field
    L = fs.nlimbs
    t = cfg.t
    row_sum = max(sum(row) for row in mat)
    E = 1
    while row_sum * fs.r >= 1 << (LIMB_BITS * (L + E)):
        E += 1
    rho = fs.r % fs.modulus
    rho_top = (rho.bit_length() - 1) // LIMB_BITS
    if (E - 1) + rho_top > L - 1:
        return None  # hi * rho fold would truncate columns
    if 2 * t * (1 << (2 * LIMB_BITS)) >= 1 << 31:
        return None  # int32 column budget of the digit accumulation
    digits = tuple(
        tuple(
            tuple(
                (q, (c >> (LIMB_BITS * q)) & LIMB_MASK)
                for q in range((c.bit_length() + LIMB_BITS - 1) // LIMB_BITS)
                if (c >> (LIMB_BITS * q)) & LIMB_MASK
            )
            for c in row
        )
        for row in mat
    )
    hi_max = (row_sum * fs.r) >> (LIMB_BITS * L)
    return {"digits": digits, "E": E, "hi_max": hi_max, "row_sum": row_sum}


@functools.lru_cache(maxsize=None)
def device_constants_monolith(cfg: MonolithConfig):
    """Round constants / matrix data in device layout (numpy)."""
    fs = cfg.field
    rc = np.stack(
        [
            np.stack([fs.int_to_mont_limbs(c) for c in row], axis=0)
            for row in cfg.rc
        ],
        axis=0,
    ).astype(np.int32)[..., None]  # (R, t, L, 1)
    consts = {"rc": rc}
    if scaled_concrete_geometry(cfg) is None:
        consts["concrete"] = np.stack(
            [
                np.stack([fs.int_to_mont_limbs(v) for v in row], axis=0)
                for row in cfg.concrete
            ],
            axis=0,
        ).astype(np.int32)[..., None]  # (t, t, L, 1)
    return consts


# ---------------------------------------------------------------------------
# Bars: canonical bit-slicing + chi S-box, all static int32 ops.
# ---------------------------------------------------------------------------


def _chi_chunk(y: jnp.ndarray, k: int) -> jnp.ndarray:
    """The k-bit chi-like S-box on an int32 lane vector (config.chunk_sbox
    semantics: 3-rotation AND for even k, 2-rotation for odd, closing <<< 1)."""
    mask = (1 << k) - 1

    def rot(v, r):
        r %= k
        if r == 0:
            return v
        return ((v << r) | (v >> (k - r))) & mask

    nb = y ^ mask  # bitwise NOT within the chunk (values are masked >= 0)
    if k % 2 == 0:
        z = y ^ (rot(nb, 1) & rot(y, 2) & rot(y, 3))
    else:
        z = y ^ (rot(nb, 1) & rot(y, 2))
    return rot(z, 1)


def _bar_plain(fs, plain: jnp.ndarray) -> jnp.ndarray:
    """Bar on canonical-exact limb planes (..., L, B): slice the value into
    bar chunks, S-box each, reassemble.  Static loops over <= 8 chunks."""
    chunks = bar_chunks(fs)
    L = fs.nlimbs
    outs = []
    bit0 = 0
    for w in chunks:
        k, off = divmod(bit0, LIMB_BITS)
        v = plain[..., k, :] >> off
        if off + w > LIMB_BITS:
            v = v | (plain[..., k + 1, :] << (LIMB_BITS - off))
        outs.append(_chi_chunk(v & ((1 << w) - 1), w))
        bit0 += w
    # Reassemble 12-bit limbs from the (disjoint) S-boxed chunks.
    limbs = []
    for li in range(L):
        lo_bit = li * LIMB_BITS
        acc = None
        bit0 = 0
        for v, w in zip(outs, chunks):
            if bit0 + w > lo_bit and bit0 < lo_bit + LIMB_BITS:
                part = (
                    v >> (lo_bit - bit0) if bit0 < lo_bit else v << (bit0 - lo_bit)
                )
                acc = part if acc is None else acc | part
            bit0 += w
        limbs.append((acc if acc is not None else jnp.zeros_like(plain[..., 0, :])) & LIMB_MASK)
    return jnp.stack(limbs, axis=-2)


# ---------------------------------------------------------------------------
# Concrete: multiplication-free scaled path (small plain-integer matrices).
# ---------------------------------------------------------------------------


def _scaled_concrete(fs, geo, state: jnp.ndarray) -> jnp.ndarray:
    """Multiplication-free MDS: out_i = sum_j c_ij * x_j on (t, L, B) mont
    planes (value < R in, value < R out) for small plain-integer matrices —
    each entry's 12-bit limb digits scale-and-place into a widened
    (L + E)-limb plane, which rho-folds back exactly.  All bounds pre-proved
    by ``scaled_concrete_geometry``."""
    digits = geo["digits"]
    E = geo["E"]
    t = len(digits)
    L = fs.nlimbs
    rho = fs.r % fs.modulus
    rho_limbs = tuple(int(v) for v in fs.int_to_limbs(rho))

    rows = []
    for i in range(t):
        terms = []
        for j in range(t):
            for q, m in digits[i][j]:
                term = state[j] if m == 1 else state[j] * m  # limbs < 2^24
                terms.append(mont._pad_limbs(term, q, E - q))
        rows.append(_tree_sum(terms))  # columns <= 2t * 2^24 (int32-proved)
    wide = jnp.stack(rows, axis=0)  # (t, L+E, B)
    wide, _top = mont._exact_pass(wide)  # top carry provably zero (bounds)
    lo, hi = wide[..., :L, :], wide[..., L:, :]
    hi_pad = mont._pad_limbs(hi, 0, L - E)  # (t, L, B), nonzero limbs < E
    folded = lo + _school_low(L, hi_pad, rho_limbs)  # value < R + hi_max*rho
    return mont.fold_norm(fs, folded, vmax=fs.r + geo["hi_max"] * rho + 1)


# ---------------------------------------------------------------------------
# Permutation.
# ---------------------------------------------------------------------------


def monolith_permute(cfg: MonolithConfig, state: jnp.ndarray) -> jnp.ndarray:
    """Full Monolith permutation on a (t, L, B) Montgomery limb-plane batch."""
    fs = cfg.field
    t = cfg.t
    consts = device_constants_monolith(cfg)
    rc = jnp.asarray(consts["rc"])  # (R, t, L, 1)
    fc = mont.field_consts(fs)
    one_plain = jnp.asarray(fc["one"])  # plain 1: mont_mul(x, 1) = from-mont
    r2 = jnp.asarray(fc["r2"])  # plain R^2 mod p: to-mont factor
    one_mont = jnp.asarray(fs.int_to_limbs(fs.r_mod_p).astype(np.int32))[:, None]
    geo = scaled_concrete_geometry(cfg)
    if geo is None:
        concrete_m = jnp.asarray(consts["concrete"])  # (t, t, L, 1)

    def concrete(st):
        """MDS layer: value < R in, value < R out."""
        if geo is not None:
            return _scaled_concrete(fs, geo, st)
        prod = mont.mont_mul_fold(fs, concrete_m, st[None])  # (t, t, L, B) < R
        return mont.fold_norm(
            fs, jnp.sum(prod, axis=1), deferred_limb_bound=t * LIMB_MASK
        )

    def round_body(r, st):
        # Bars on the leading u elements: mont -> canonical bits -> chi ->
        # mont.  canonicalize needs value < 2p; mont_mul(x, 1) guarantees it.
        barred = st[: cfg.bars]
        plain = mont.canonicalize(fs, mont.mont_mul(fs, barred, one_plain))
        plain = _bar_plain(fs, plain)  # canonical < p (range-preserving)
        barred = mont.mont_mul(fs, plain, r2)  # back to mont, value < 2p < R
        st = jnp.concatenate([barred, st[cfg.bars :]], axis=0)
        # Bricks: x_i += x_{i-1}^2 on the ORIGINAL values (parallel Feistel).
        sq = mont.mont_mul_fold(fs, st[:-1], st[:-1])  # value < R
        tail = mont.fold_norm(fs, st[1:] + sq, vmax=2 * fs.r)
        st = jnp.concatenate([st[:1], tail], axis=0)
        # Concrete + round constants (last row is zeros — validated).
        st = concrete(st)
        return mont.fold_norm(fs, st + rc[r], deferred_limb_bound=2 * LIMB_MASK)

    state = concrete(state)  # opening linear layer
    state = jax.lax.fori_loop(0, cfg.rounds, round_body, state)
    # Close with a Montgomery-by-1 multiply: x < R strictly => out < 2p (the
    # framework-wide output invariant absorb-add and from_mont rely on).
    return mont.mont_mul(fs, state, one_mont)


@functools.lru_cache(maxsize=None)
def monolith_permute_jit(cfg: MonolithConfig):
    return jax.jit(functools.partial(monolith_permute, cfg))


def batched_monolith_permute(cfg: MonolithConfig, state, backend: str = "auto"):
    """Batched Monolith permutation: the XLA tier on every platform (this family
    has no fused kernel; ``backend`` is "auto" or "xla")."""
    require_xla_backend(backend, "Monolith")
    return monolith_permute_jit(cfg)(state)