"""Batched duplex Poseidon sponge over device limb planes.

The `CryptographicSponge`/`FieldBasedCryptographicSponge` surface
(the reference's src/lib.rs:105-195, poseidon/mod.rs:216-342), re-architected as a
*batched* sponge: one instance advances ``B`` independent sponge lanes in lockstep.
The duplex bookkeeping (mode, rate index, chunking) is host-side Python — it is
data-independent control flow shared by all lanes — while the state lives on
device as a ``(t, L, B)`` int32 Montgomery limb plane and every permutation is the
batched jitted kernel.  Throughput therefore comes entirely from batch width
(SURVEY.md §7.3 item 5): the API makes the batch axis first-class so users never
fall into single-state loops.

Parity quirks preserved (see ``poseidon/oracle.py`` for the scalar reference):
absorb *adds* into the rate region; the squeeze loop's missing permute when the
remaining output equals the rate; `Truncated` sizes that never truncate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from . import absorb as absorb_codec
from .fields import FieldSpec
from .ops import montgomery as mont
from .poseidon.config import PoseidonConfig
from .poseidon.oracle import (
    FULL,
    SpongeState,
    field_element_size_num_bits,
)
from .poseidon.permutation import zero_state

ABSORBING = "absorbing"
SQUEEZING = "squeezing"


@dataclass(frozen=True)
class Batched:
    """Per-lane absorb input: one codec value per lane, identical structure.

    All lanes of a batched sponge share control flow, so every lane's value must
    encode to the same number of field elements (same types/lengths, different
    values) — the natural shape of a batched Fiat–Shamir transcript.
    """

    lanes: Sequence


def encode_ints_plane(fs: FieldSpec, values) -> np.ndarray:
    """(k, B) or (k,) python-int grid -> (k, L, B) int32 Montgomery plane.

    Routes through ``FieldSpec.ints_to_mont_plane`` (native C++ codec when
    available) with a single flattened call instead of k*B python conversions.
    """
    arr = np.asarray(values, dtype=object)
    if arr.ndim == 1:
        arr = arr[:, None]
    k, B = arr.shape
    if k == 0:
        return np.empty((0, fs.nlimbs, B), dtype=np.int32)
    flat = fs.ints_to_mont_plane(arr.reshape(-1))  # (L, k*B)
    return np.ascontiguousarray(
        flat.reshape(fs.nlimbs, k, B).transpose(1, 0, 2)
    )


def decode_canonical_plane(fs: FieldSpec, plane) -> list:
    """(k, L, B) canonical (non-Montgomery) plane -> lane-major ints [B][k]."""
    plane = np.asarray(plane)
    k, _, B = plane.shape
    return [
        [fs.limbs_to_int(plane[i, :, b]) for i in range(k)] for b in range(B)
    ]


class PoseidonSponge:
    """Batched Poseidon duplex sponge (the reference ``PoseidonSponge`` surface).

    Squeeze outputs are lane-major: ``squeeze_native_field_elements(n)`` returns
    ``[B][n]`` ints, ``squeeze_bytes(n)`` returns ``[B]`` byte strings, etc.

    Dispatch is segment-batched BY DEFAULT (``lazy=True``): absorbs queue
    host-side and each squeeze flushes the pending ``[Absorb..., Squeeze]``
    segment as ONE jitted program, cached by segment shape — a Fiat–Shamir
    loop with stable per-iteration structure compiles once and then costs a
    single device dispatch per iteration instead of several per duplex
    step.  Results are bit-for-bit identical to ``lazy=False`` (the
    step-by-step eager path, kept for differential testing and for callers
    that need ``.plane`` to reflect every absorb immediately — in lazy mode
    the device plane materializes at the next flush; ``into_state()``
    flushes).  ``.mode`` / ``.index`` are ALWAYS live: over queued lazy
    absorbs they replay the host-static duplex bookkeeping
    (``segment_bookkeeping``), so they match the reference's eager machine
    at every point.
    """

    #: Lazy mode flushes an absorb-only segment once this many element rows
    #: are queued, so unbounded ``absorb_stream`` runs keep bounded host
    #: memory while still batching dispatches.
    FLUSH_ROWS = 256

    def __init__(
        self,
        cfg: PoseidonConfig,
        batch_size: int = 1,
        lazy: bool = True,
        backend: str = "auto",
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        # The device plane is padded to a power-of-two lane bucket (>= 8) so that
        # sponges with nearby batch sizes share one XLA compilation of the
        # permutation; the padding lanes run a valid all-zero sponge.
        self._padded = max(8, 1 << (batch_size - 1).bit_length())
        self.plane = zero_state(cfg, self._padded)  # (t, L, Bp), mod.rs:220
        self._pending: list = []  # queued (k, L, Bp) element planes (lazy mode)
        self.mode = ABSORBING
        self.index = 0
        self._lazy = lazy
        self._backend = backend

    # ---- duplex bookkeeping (virtual over queued lazy absorbs) ----

    @property
    def mode(self) -> str:
        """Duplex mode, exactly as the reference's eager machine would report
        it (mod.rs:121-182): queued lazy absorbs are accounted for by
        replaying the host-static bookkeeping over the pending rows —
        ``.mode`` / ``.index`` are therefore always live, even though the
        device ``.plane`` materializes only at the next flush."""
        if self._pending:
            return self._virtual_bookkeeping()[0]
        return self._mode

    @mode.setter
    def mode(self, value: str):
        self._mode = value

    @property
    def index(self) -> int:
        """Rate index (see ``mode`` — live over queued lazy absorbs)."""
        if self._pending:
            return self._virtual_bookkeeping()[1]
        return self._index

    @index.setter
    def index(self, value: int):
        self._index = value

    def _virtual_bookkeeping(self):
        from .transcript import Absorb, segment_bookkeeping

        steps = tuple(Absorb(p.shape[0]) for p in self._pending)
        return segment_bookkeeping(self.cfg, steps, self._mode, self._index)

    # ---- core duplex machinery over device planes ----

    def _permute(self):
        from .poseidon.permutation import batched_permute

        self.plane = batched_permute(self.cfg, self.plane)

    def _add_into_rate(self, start: int, chunk: jnp.ndarray):
        """state[capacity+start : capacity+start+k] += chunk  (mod.rs:128,143)."""
        k = chunk.shape[0]
        lo = self.cfg.capacity + start
        rows = self.plane[lo : lo + k]
        self.plane = self.plane.at[lo : lo + k].set(
            mont.mont_add(self.cfg.field, rows, jnp.asarray(chunk))
        )

    def _absorb_internal(self, rate_start_index: int, elems: np.ndarray):
        """mod.rs:121-150 over a (k, L, B) element plane."""
        rate = self.cfg.rate
        remaining = elems
        while True:
            if rate_start_index + remaining.shape[0] <= rate:
                if remaining.shape[0] > 0:
                    self._add_into_rate(rate_start_index, remaining)
                self.mode = ABSORBING
                self.index = rate_start_index + remaining.shape[0]
                return
            num = rate - rate_start_index
            self._add_into_rate(rate_start_index, remaining[:num])
            self._permute()
            remaining = remaining[num:]
            rate_start_index = 0

    def _squeeze_internal(self, rate_start_index: int, num: int) -> jnp.ndarray:
        """mod.rs:153-182; returns (num, L, B) Montgomery plane."""
        cfg = self.cfg
        outs = []
        remaining = num
        while True:
            if rate_start_index + remaining <= cfg.rate:
                lo = cfg.capacity + rate_start_index
                outs.append(self.plane[lo : lo + remaining])
                self.mode = SQUEEZING
                self.index = rate_start_index + remaining
                return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
            num_squeezed = cfg.rate - rate_start_index
            lo = cfg.capacity + rate_start_index
            outs.append(self.plane[lo : lo + num_squeezed])
            # Parity quirk: skip the permute when the remaining output equals the
            # rate (mod.rs:174-177).
            if remaining != cfg.rate:
                self._permute()
            remaining -= num_squeezed
            rate_start_index = 0

    # ---- absorb (mod.rs:232-254) ----

    def absorb(self, x):
        """Absorb a codec value (broadcast to all lanes) or a ``Batched`` input."""
        fs = self.cfg.field
        if isinstance(x, Batched):
            lanes = list(x.lanes)
            if len(lanes) != self.batch_size:
                raise ValueError("Batched input must have one value per lane")
            encoded = [absorb_codec.to_sponge_field_elements(v, fs) for v in lanes]
            lens = {len(e) for e in encoded}
            if len(lens) != 1:
                raise ValueError(
                    "Batched lanes must encode to the same number of elements"
                )
            grid = np.asarray(encoded, dtype=object).T  # (k, B)
            if grid.shape[0] == 0:
                return  # empty absorb is a no-op (mod.rs:234-236)
            self.absorb_element_plane(encode_ints_plane(fs, grid))
            return
        # Broadcast input: encode each element ONCE and broadcast across lanes.
        elems = absorb_codec.to_sponge_field_elements(x, fs)
        if not elems:
            return
        col = encode_ints_plane(fs, [[e] for e in elems])  # (k, L, 1)
        self.absorb_element_plane(
            np.broadcast_to(col, (len(elems), fs.nlimbs, self.batch_size))
        )

    def absorb_stream(self, chunks) -> int:
        """Absorb an iterable of inputs larger than memory, chunk by chunk.

        Each chunk may be a pre-encoded ``(k, L, B)`` Montgomery element plane
        (fast path, zero host-side encoding) or any codec value / ``Batched``
        accepted by :meth:`absorb`.  The duplex state machine is inherently
        streaming (rate-chunked absorb loop, mod.rs:121-150), so this is pure
        convenience: transcripts of unbounded length absorb in bounded memory.
        Returns the number of chunks consumed.
        """
        n = 0
        for chunk in chunks:
            if isinstance(chunk, np.ndarray) and chunk.ndim == 3:
                self.absorb_element_plane(chunk)
            else:
                self.absorb(chunk)
            n += 1
        return n

    def absorb_element_plane(self, elems: np.ndarray):
        """Absorb a pre-encoded (k, L, B) Montgomery element plane (fast path)."""
        if elems.shape[0] == 0:
            return
        if elems.shape[-1] != self._padded:
            if elems.shape[-1] != self.batch_size:
                raise ValueError("element plane batch axis must match batch_size")
            pad = self._padded - elems.shape[-1]
            elems = np.pad(np.asarray(elems), [(0, 0), (0, 0), (0, pad)])
        if self._lazy:
            self._pending.append(np.asarray(elems))
            if sum(p.shape[0] for p in self._pending) >= self.FLUSH_ROWS:
                self._flush(0)
            return
        if self.mode == ABSORBING:
            absorb_index = self.index
            if absorb_index == self.cfg.rate:
                self._permute()
                absorb_index = 0
            self._absorb_internal(absorb_index, elems)
        else:
            self._permute()
            self._absorb_internal(0, elems)

    # ---- lazy (segment-batched) dispatch ----

    def _flush(self, squeeze_n: int = 0):
        """Run all queued absorbs (plus an optional squeeze) as one jitted
        segment (see class docstring).  Returns the squeezed canonical
        ``(squeeze_n, L, Bp)`` plane, or None when ``squeeze_n == 0``."""
        from .lazy import _segment_fn
        from .transcript import Absorb, SqueezeNative

        steps = tuple(Absorb(p.shape[0]) for p in self._pending)
        if squeeze_n:
            steps = steps + (SqueezeNative(squeeze_n),)
        if not steps:
            return None
        fn, end_mode, end_index = _segment_fn(
            self.cfg, steps, self._mode, self._index, self._backend
        )
        L = self.cfg.field.nlimbs
        elems = (
            np.concatenate(self._pending, axis=0)
            if self._pending
            else np.zeros((0, L, self._padded), dtype=np.int32)
        )
        self._pending = []
        out, self.plane = fn(self.plane, jnp.asarray(elems))
        self.mode, self.index = end_mode, end_index
        return out if squeeze_n else None

    # ---- squeezes (mod.rs:256-341) ----

    def squeeze_native_plane(self, num: int) -> jnp.ndarray:
        """(num, L, B) *canonical* limb plane of squeezed native elements."""
        if self._lazy:
            return self._flush(num)[..., : self.batch_size]
        if self.mode == ABSORBING:
            self._permute()
            out_mont = self._squeeze_internal(0, num)
        else:
            squeeze_index = self.index
            if squeeze_index == self.cfg.rate:
                self._permute()
                squeeze_index = 0
            out_mont = self._squeeze_internal(squeeze_index, num)
        return mont.from_mont(self.cfg.field, out_mont)[..., : self.batch_size]

    def squeeze_native_field_elements(self, num: int) -> list:
        """Lane-major ints [B][num] (FieldBasedCryptographicSponge, mod.rs:321-341)."""
        return decode_canonical_plane(self.cfg.field, self.squeeze_native_plane(num))

    def squeeze_bytes_plane(self, num_bytes: int) -> np.ndarray:
        """(B, num_bytes) uint8 array; low usable bytes of each element
        (mod.rs:256-270), extracted from the canonical limb plane with
        vectorized numpy (no per-lane python bigint loops — at B = 2^17 the
        per-lane path is ~1000x slower)."""
        fs = self.cfg.field
        usable = (fs.modulus_bit_size - 1) // 8
        num_elements = -(-num_bytes // usable)
        plane = np.asarray(self.squeeze_native_plane(num_elements))  # (k, L, B)
        lb = fs.limb_bits
        j = np.arange(usable)
        l = (8 * j) // lb
        o = (8 * j) % lb
        # Byte j spans at most two adjacent limbs (8 < limb_bits).
        lo = plane[:, l, :] >> o[None, :, None]
        hi_l = np.minimum(l + 1, fs.nlimbs - 1)
        hi_valid = (l + 1 < fs.nlimbs)[None, :, None]
        hi = np.where(hi_valid, plane[:, hi_l, :], 0) << (lb - o)[None, :, None]
        byts = ((lo | hi) & 0xFF).astype(np.uint8)  # (k, usable, B)
        k, _, B = byts.shape
        return byts.transpose(2, 0, 1).reshape(B, k * usable)[:, :num_bytes]

    def squeeze_bytes(self, num_bytes: int) -> list:
        """[B] byte strings; low usable bytes of each element (mod.rs:256-270)."""
        grid = self.squeeze_bytes_plane(num_bytes)
        return [grid[b].tobytes() for b in range(grid.shape[0])]

    def squeeze_bits_plane(self, num_bits: int) -> np.ndarray:
        """(B, num_bits) bool array; low usable LE bits of each element
        (mod.rs:272-286), vectorized like ``squeeze_bytes_plane``."""
        fs = self.cfg.field
        usable = fs.modulus_bit_size - 1
        num_elements = -(-num_bits // usable)
        plane = np.asarray(self.squeeze_native_plane(num_elements))  # (k, L, B)
        lb = fs.limb_bits
        i = np.arange(usable)
        bits = (plane[:, i // lb, :] >> (i % lb)[None, :, None]) & 1  # (k, usable, B)
        k, _, B = bits.shape
        return bits.transpose(2, 0, 1).reshape(B, k * usable)[:, :num_bits].astype(bool)

    def squeeze_bits(self, num_bits: int) -> list:
        """[B] bool lists; low usable bits of each element (mod.rs:272-286)."""
        grid = self.squeeze_bits_plane(num_bits)
        return [[bool(v) for v in grid[b]] for b in range(grid.shape[0])]

    def squeeze_field_elements_with_sizes(self, target_fs: FieldSpec, sizes) -> list:
        """[B][len(sizes)] ints in ``target_fs`` (mod.rs:288-304)."""
        fs = self.cfg.field
        if fs.modulus == target_fs.modulus:
            lanes = self.squeeze_native_field_elements_with_sizes(sizes)
            return [[v % target_fs.modulus for v in lane] for lane in lanes]
        return self._squeeze_nonnative_default(target_fs, sizes)

    def squeeze_field_elements(self, target_fs: FieldSpec, num: int) -> list:
        """[B][num] ints in ``target_fs`` (mod.rs:306-317)."""
        if self.cfg.field.modulus == target_fs.modulus:
            return self.squeeze_native_field_elements(num)
        return self.squeeze_field_elements_with_sizes(target_fs, [FULL] * num)

    def squeeze_native_field_elements_with_sizes(self, sizes) -> list:
        """lib.rs:168-182."""
        if all(s == FULL for s in sizes):
            return self.squeeze_native_field_elements(len(sizes))
        return self._squeeze_nonnative_default(self.cfg.field, sizes)

    def _squeeze_nonnative_default(self, target_fs: FieldSpec, sizes) -> list:
        """lib.rs:61-100 (num_bits measured against the target field).

        Bit extraction and LE byte packing are vectorized across lanes
        (np.packbits over the bit plane); only the final modular reduction is a
        per-output bigint op."""
        if len(sizes) == 0:
            return [[] for _ in range(self.batch_size)]
        per = [field_element_size_num_bits(s, target_fs) for s in sizes]
        grid = self.squeeze_bits_plane(sum(per))  # (B, total_bits)
        out = []
        for b in range(grid.shape[0]):
            lane, pos = [], 0
            for n in per:
                window = grid[b, pos : pos + n]
                pos += n
                packed = np.packbits(window, bitorder="little").tobytes()
                lane.append(target_fs.from_le_bytes_mod_order(packed))
            out.append(lane)
        return out

    # ---- fork / clone / SpongeExt ----

    def fork(self, domain: bytes) -> "PoseidonSponge":
        """Domain separation (lib.rs:149-157)."""
        new = self.clone()
        payload = absorb_codec.to_sponge_bytes(
            absorb_codec.Usize(len(domain))
        ) + bytes(domain)
        new.absorb(payload)
        return new

    def clone(self) -> "PoseidonSponge":
        new = type(self).__new__(type(self))
        new.cfg = self.cfg
        new.batch_size = self.batch_size
        new._padded = self._padded
        new.plane = self.plane
        new._mode = self._mode  # raw flushed state; pending is copied below
        new._index = self._index
        new._lazy = self._lazy
        new._backend = self._backend
        new._pending = list(self._pending)  # planes are immutable, share them
        return new

    def into_state(self) -> SpongeState:
        """Externalize {state, mode, index} as host values (lib.rs:188-195)."""
        if self._lazy:
            self._flush(0)
        canonical = mont.from_mont(self.cfg.field, self.plane)[..., : self.batch_size]
        lanes = decode_canonical_plane(self.cfg.field, canonical)
        return SpongeState(
            state=[list(col) for col in np.asarray(lanes, dtype=object).T],
            mode=self.mode,
            index=self.index,
        )

    @classmethod
    def from_state(
        cls, state: SpongeState, cfg: PoseidonConfig, batch_size: Optional[int] = None
    ) -> "PoseidonSponge":
        rows = state.state  # [t][B] ints
        B = batch_size if batch_size is not None else len(rows[0])
        new = cls(cfg, B)
        plane = encode_ints_plane(cfg.field, rows)
        pad = new._padded - plane.shape[-1]
        new.plane = jnp.asarray(np.pad(plane, [(0, 0), (0, 0), (0, pad)]))
        new.mode = state.mode
        new.index = state.index
        return new
