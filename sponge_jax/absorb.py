"""The Absorb input codec: typed host values -> sponge wire formats.

Mirror of the reference's src/absorb.rs.  The sponge consumes two wire
formats — a byte stream and a field-element stream — and every absorbable type
defines its encoding into both.  This is pure host-side data movement (never on the
device hot path), so it is plain Python over arbitrary-precision ints.

Type mapping (reference impl -> here):
  u8/u16/u32/u64/u128, i8..i128     -> ``U8(..)`` .. ``I128(..)`` int subclasses
  usize / isize                     -> ``Usize`` / ``Isize`` (64-bit semantics,
                                       absorb.rs:210-228)
  bool                              -> python ``bool``
  Fp                                -> ``Fp(value, field)``
  &[u8] / Vec<u8>                   -> python ``bytes`` / ``bytearray``
  &[A] / Vec<A>                     -> python ``list``
  Option<A>                         -> ``Some(x)`` / ``NONE``
  TEAffine / SWAffine               -> ``TEPoint`` / ``SWPoint``
  AbsorbWithLength                  -> ``WithLength(x)``
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .fields import FieldSpec


# ---------------------------------------------------------------------------------
# Typed wrappers
# ---------------------------------------------------------------------------------


class _TypedInt(int):
    """Fixed-width integer wrapper carrying the reference's absorb semantics."""

    BITS: int = 0
    SIGNED: bool = False

    def __new__(cls, value: int):
        bits, signed = cls.BITS, cls.SIGNED
        lo = -(1 << (bits - 1)) if signed else 0
        hi = (1 << (bits - 1)) if signed else (1 << bits)
        if not lo <= int(value) < hi:
            raise ValueError(f"{cls.__name__} out of range: {value}")
        return super().__new__(cls, value)


def _make_int(name: str, bits: int, signed: bool):
    return type(name, (_TypedInt,), {"BITS": bits, "SIGNED": signed})


U8 = _make_int("U8", 8, False)
U16 = _make_int("U16", 16, False)
U32 = _make_int("U32", 32, False)
U64 = _make_int("U64", 64, False)
U128 = _make_int("U128", 128, False)
I8 = _make_int("I8", 8, True)
I16 = _make_int("I16", 16, True)
I32 = _make_int("I32", 32, True)
I64 = _make_int("I64", 64, True)
I128 = _make_int("I128", 128, True)
# usize/isize absorb with 64-bit semantics (absorb.rs:210-228).
Usize = _make_int("Usize", 64, False)
Isize = _make_int("Isize", 64, True)


@dataclass(frozen=True)
class Fp:
    """A prime-field element tagged with its field (reference ``Fp<P, N>``)."""

    value: int
    field: FieldSpec

    def __post_init__(self):
        object.__setattr__(self, "value", int(self.value) % self.field.modulus)


@dataclass(frozen=True)
class Some:
    """``Option::Some`` (absorb.rs:288-302)."""

    value: object


class _NoneType:
    """``Option::None`` singleton."""

    _instance: Optional["_NoneType"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NONE"


NONE = _NoneType()


@dataclass(frozen=True)
class WithLength:
    """``AbsorbWithLength``: prepend the element count (absorb.rs:82-101)."""

    value: object


@dataclass(frozen=True)
class SWPoint:
    """Short-Weierstrass affine point; absorbs as base-field coords + infinity flag.

    Mirrors absorb.rs:243-254 via ark-ec's ``ToConstraintField`` for SW affine
    ([x, y, infinity]); the identity encodes as x = y = 0, infinity = 1.
    """

    x: Fp
    y: Fp
    infinity: bool = False

    def to_field_elements(self):
        return [self.x, self.y, Fp(int(self.infinity), self.x.field)]


@dataclass(frozen=True)
class TEPoint:
    """Twisted-Edwards affine point; absorbs as [x, y] (absorb.rs:230-241)."""

    x: Fp
    y: Fp

    def to_field_elements(self):
        return [self.x, self.y]


# ---------------------------------------------------------------------------------
# Field-element wire format (to_sponge_field_elements)
# ---------------------------------------------------------------------------------


def bytes_to_field_elements(data: bytes, fs: FieldSpec) -> list:
    """ark-ff ``ToConstraintField for [u8]`` packing (used at absorb.rs:138).

    Chunks of ``(MODULUS_BIT_SIZE - 1) / 8`` bytes, each interpreted as a
    little-endian integer (always < p since the chunk has fewer bits than the
    modulus).
    """
    if len(data) >= 1024:
        from .utils.native import pack_bytes_to_elements_native

        packed = pack_bytes_to_elements_native(fs, data)
        if packed is not None:
            return packed
    max_size = (fs.modulus_bit_size - 1) // 8
    return [
        int.from_bytes(data[i : i + max_size], "little")
        for i in range(0, len(data), max_size)
    ]


def _u8_batch_to_field_elements(data: bytes, fs: FieldSpec) -> list:
    """u8 batch: prepend u64 LE length, then pack (absorb.rs:135-139)."""
    payload = len(data).to_bytes(8, "little") + bytes(data)
    return bytes_to_field_elements(payload, fs)


def field_cast(values, src: FieldSpec, dst: FieldSpec) -> Optional[list]:
    """Same-characteristic checked cast (absorb.rs:106-120); None on mismatch."""
    if src.modulus != dst.modulus:
        return None
    return [int(v) % dst.modulus for v in values]


def to_sponge_field_elements(x, fs: FieldSpec, dest: Optional[list] = None) -> list:
    """Encode ``x`` into the field-element wire format for field ``fs``.

    Dispatch mirrors the per-type ``Absorb`` impls in absorb.rs (see module doc).
    """
    out = dest if dest is not None else []

    if isinstance(x, bool):
        out.append(int(x))  # absorb.rs:147-149
    elif isinstance(x, _TypedInt):
        v = int(x)
        if x.SIGNED and v < 0:
            out.append((-abs(v)) % fs.modulus)  # -F::from(abs), absorb.rs:193-198
        else:
            out.append(v % fs.modulus)
    elif isinstance(x, int) and not isinstance(x, bool):
        raise TypeError(
            "plain python ints are ambiguous; wrap in U8..U128/I8..I128/Usize/Fp"
        )
    elif isinstance(x, Fp):
        # Single nonnative Fp: field_cast failure is silently ignored
        # (``let _ = field_cast`` at absorb.rs:156-158) — replicate the no-op.
        cast = field_cast([x.value], x.field, fs)
        if cast is not None:
            out.extend(cast)
    elif isinstance(x, (bytes, bytearray)):
        out.extend(_u8_batch_to_field_elements(bytes(x), fs))
    elif isinstance(x, list):
        _batch_to_field_elements(x, fs, out)
    elif isinstance(x, Some):
        out.append(1)  # is_some flag, absorb.rs:296-301
        to_sponge_field_elements(x.value, fs, out)
    elif x is NONE:
        out.append(0)
    elif isinstance(x, (SWPoint, TEPoint)):
        coords = x.to_field_elements()
        cast = field_cast([c.value for c in coords], coords[0].field, fs)
        if cast is None:
            raise ValueError("absorbing curve point over a non-native base field")
        out.extend(cast)
    elif isinstance(x, WithLength):
        # length as usize, then the payload (absorb.rs:97-100).
        to_sponge_field_elements(Usize(_absorb_length(x.value)), fs, out)
        to_sponge_field_elements(x.value, fs, out)
    else:
        raise TypeError(f"not absorbable: {type(x)!r}")
    return out


def _batch_to_field_elements(batch: list, fs: FieldSpec, out: list):
    """``&[A]`` batch semantics: per-type batch impl, default = concat each."""
    if batch and all(isinstance(e, U8) for e in batch):
        # Vec<u8> routes through the u8 batch impl (length prefix + packing).
        out.extend(_u8_batch_to_field_elements(bytes(int(e) for e in batch), fs))
        return
    if batch and all(isinstance(e, Fp) for e in batch):
        # Fp batch: field_cast with unwrap — mismatch panics (absorb.rs:159-164).
        cast = field_cast([e.value for e in batch], batch[0].field, fs)
        if cast is None:
            raise ValueError("Trying to absorb non-native field elements.")
        out.extend(cast)
        return
    for e in batch:
        to_sponge_field_elements(e, fs, out)


def _absorb_length(x) -> int:
    if isinstance(x, (bytes, bytearray, list)):
        return len(x)
    raise TypeError(f"AbsorbWithLength requires a sequence, got {type(x)!r}")


# ---------------------------------------------------------------------------------
# Byte wire format (to_sponge_bytes)
# ---------------------------------------------------------------------------------


def _fp_serialize_compressed(x: Fp) -> bytes:
    """ark-serialize compressed Fp: canonical little-endian, ceil(bits/8) bytes."""
    return x.value.to_bytes(x.field.num_canonical_bytes, "little")


def to_sponge_bytes(x, dest: Optional[bytearray] = None) -> bytes:
    """Encode ``x`` into the byte wire format (absorb.rs per-type impls)."""
    out = dest if dest is not None else bytearray()

    if isinstance(x, bool):
        out.append(int(x))
    elif isinstance(x, _TypedInt):
        v = int(x)
        nbytes = x.BITS // 8
        out.extend(v.to_bytes(nbytes, "little", signed=x.SIGNED))
    elif isinstance(x, int) and not isinstance(x, bool):
        raise TypeError(
            "plain python ints are ambiguous; wrap in U8..U128/I8..I128/Usize/Fp"
        )
    elif isinstance(x, Fp):
        out.extend(_fp_serialize_compressed(x))
    elif isinstance(x, (bytes, bytearray)):
        out.extend(bytes(x))  # u8 batch: raw bytes, no prefix (absorb.rs:131-133)
    elif isinstance(x, list):
        if x and all(isinstance(e, U8) for e in x):
            out.extend(bytes(int(e) for e in x))
        else:
            for e in x:  # default batch: concat each (absorb.rs:39-46)
                to_sponge_bytes(e, out)
    elif isinstance(x, Some):
        out.append(1)
        to_sponge_bytes(x.value, out)
    elif x is NONE:
        out.append(0)
    elif isinstance(x, (SWPoint, TEPoint)):
        # serialize_compressed of the coordinate Vec: u64 LE length prefix then
        # each coordinate compressed (absorb.rs:231-236, 244-249).
        coords = x.to_field_elements()
        out.extend(len(coords).to_bytes(8, "little"))
        for c in coords:
            out.extend(_fp_serialize_compressed(c))
    elif isinstance(x, WithLength):
        to_sponge_bytes(Usize(_absorb_length(x.value)), out)
        to_sponge_bytes(x.value, out)
    else:
        raise TypeError(f"not absorbable: {type(x)!r}")
    return bytes(out)


def collect_sponge_bytes(*items) -> bytes:
    """``collect_sponge_bytes!`` macro analogue (absorb.rs:330-340)."""
    out = bytearray()
    for item in items:
        to_sponge_bytes(item, out)
    return bytes(out)


def collect_sponge_field_elements(fs: FieldSpec, *items) -> list:
    """``collect_sponge_field_elements!`` macro analogue (absorb.rs:344-354)."""
    out = []
    for item in items:
        to_sponge_field_elements(item, fs, out)
    return out
