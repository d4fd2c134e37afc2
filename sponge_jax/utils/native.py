"""ctypes loader for the native host codec (csrc/host_codec.cc).

The shared library is built on first use with the system C++ compiler and cached
under ``csrc/build`` in the checkout; every entry point degrades gracefully to the pure
Python implementation when the toolchain or binary is unavailable, so the
framework never *requires* the native tier — it is a host-throughput
optimization (the device hot path is unaffected either way).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parent.parent.parent / "csrc"
_SRC = _CSRC / "host_codec.cc"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compile_shared(src: pathlib.Path, stem: str) -> Optional[ctypes.CDLL]:
    """Build (once, content-hashed into ``csrc/build`` inside the checkout,
    git-ignored) and dlopen a csrc file."""
    if not src.exists():
        return None
    cache = _CSRC / "build"
    try:
        cache.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = cache / f"lib{stem}-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        for cc in ("c++", "g++", "clang++"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-pthread", "-o", str(tmp), str(src)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                tmp.rename(so)
                break
            except (OSError, subprocess.SubprocessError):
                continue
        else:
            return None
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        return None


def _build() -> Optional[ctypes.CDLL]:
    lib = _compile_shared(_SRC, "hostcodec")
    if lib is None:
        return None
    lib.encode_mont_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.decode_mont_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.pack_bytes_to_elements.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p
    ]
    lib.pack_bytes_to_elements.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable (pure-python fallback)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _build()
            _TRIED = True
    return _LIB


_POSEIDON_SRC = _CSRC / "poseidon_host.cc"
_POSEIDON_LIB: Optional[ctypes.CDLL] = None
_POSEIDON_TRIED = False


def _build_poseidon() -> Optional[ctypes.CDLL]:
    lib = _compile_shared(_POSEIDON_SRC, "poseidonhost")
    if lib is None:
        return None
    lib.poseidon_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx: p (4 x u64 LE) + n0inv
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # full_rounds
        ctypes.c_int32,   # partial_rounds
        ctypes.c_void_p,  # ark (R*t*4 u64, Montgomery)
        ctypes.c_void_p,  # mds (t*t*4 u64, Montgomery)
        ctypes.c_void_p,  # opt (nullable packed optimized-partial tables)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.poseidon_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # full_rounds
        ctypes.c_int32,   # partial_rounds
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # ark
        ctypes.c_void_p,  # mds
        ctypes.c_void_p,  # opt (nullable)
        ctypes.c_void_p,  # steps (n_steps x {kind, count} int32)
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems (absorbed, Montgomery u64 words)
        ctypes.c_void_p,  # out (squeezed, Montgomery u64 words)
        ctypes.c_void_p,  # state_io (t*4 u64, in/out)
        ctypes.c_void_p,  # bk ({mode, index} int32, in/out)
    ]
    lib.poseidon2_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # full_rounds
        ctypes.c_int32,   # partial_rounds
        ctypes.c_void_p,  # ext_rc (R_F*t*4 u64, Montgomery)
        ctypes.c_void_p,  # int_rc (R_P*4 u64, Montgomery)
        ctypes.c_void_p,  # mat_e (t*t int32, small plain ints)
        ctypes.c_void_p,  # diag_m1 (t*4 u64, Montgomery of mu-1)
        ctypes.c_void_p,  # diag_small (t int32 plain mu-1, nullable fast path)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.poseidon2_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # full_rounds
        ctypes.c_int32,   # partial_rounds
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # ext_rc
        ctypes.c_void_p,  # int_rc
        ctypes.c_void_p,  # mat_e
        ctypes.c_void_p,  # diag_m1
        ctypes.c_void_p,  # diag_small (nullable)
        ctypes.c_void_p,  # steps
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # state_io
        ctypes.c_void_p,  # bk
    ]
    lib.rescue_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_void_p,  # rc (2*rounds*t*4 u64, Montgomery)
        ctypes.c_void_p,  # mds (t*t*4 u64, Montgomery)
        ctypes.c_void_p,  # inv_alpha (4 u64 LE plain exponent)
        ctypes.c_void_p,  # one_mont (4 u64: Montgomery 1)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.rescue_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # rc
        ctypes.c_void_p,  # mds
        ctypes.c_void_p,  # inv_alpha
        ctypes.c_void_p,  # one_mont
        ctypes.c_void_p,  # steps
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # state_io
        ctypes.c_void_p,  # bk
    ]
    lib.anemoi_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_void_p,  # rc_x (rounds*l*4 u64, Montgomery)
        ctypes.c_void_p,  # rc_y (rounds*l*4 u64, Montgomery)
        ctypes.c_void_p,  # mat (l*l*4 u64, Montgomery)
        ctypes.c_void_p,  # g (4 u64, Montgomery)
        ctypes.c_void_p,  # g_inv (4 u64, Montgomery)
        ctypes.c_void_p,  # inv_alpha (4 u64 LE plain exponent)
        ctypes.c_void_p,  # one_mont (4 u64: Montgomery 1)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.anemoi_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # rc_x
        ctypes.c_void_p,  # rc_y
        ctypes.c_void_p,  # mat
        ctypes.c_void_p,  # g
        ctypes.c_void_p,  # g_inv
        ctypes.c_void_p,  # inv_alpha
        ctypes.c_void_p,  # one_mont
        ctypes.c_void_p,  # steps
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # state_io
        ctypes.c_void_p,  # bk
    ]
    lib.griffin_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_void_p,  # rc ((rounds-1)*t*4 u64, Montgomery)
        ctypes.c_void_p,  # mat_e (t*t int32, small plain ints)
        ctypes.c_void_p,  # qa ((t-2)*4 u64, Montgomery alpha_i)
        ctypes.c_void_p,  # qb ((t-2)*4 u64, Montgomery beta_i)
        ctypes.c_void_p,  # inv_alpha (4 u64 LE plain exponent)
        ctypes.c_void_p,  # one_mont (4 u64: Montgomery 1)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.griffin_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # rc
        ctypes.c_void_p,  # mat_e
        ctypes.c_void_p,  # qa
        ctypes.c_void_p,  # qb
        ctypes.c_void_p,  # inv_alpha
        ctypes.c_void_p,  # one_mont
        ctypes.c_void_p,  # steps
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # state_io
        ctypes.c_void_p,  # bk
    ]
    lib.gmimc_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_void_p,  # rc (rounds*4 u64, Montgomery)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.gmimc_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # alpha
        ctypes.c_int32,   # rounds
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # rc
        ctypes.c_void_p,  # steps
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # state_io
        ctypes.c_void_p,  # bk
    ]
    lib.monolith_permute_host.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # rounds
        ctypes.c_int32,   # bars (u)
        ctypes.c_int32,   # n_bits (modulus bit length)
        ctypes.c_int32,   # bar_m (extra chunk boundary; 0/1 = none)
        ctypes.c_void_p,  # rc (rounds*t*4 u64, Montgomery, last row zero)
        ctypes.c_void_p,  # concrete (t*t*4 u64, Montgomery)
        ctypes.c_void_p,  # r2 (4 u64: R^2 mod p)
        ctypes.c_void_p,  # states (n*t*4 u64, in-place)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # n_threads
    ]
    lib.monolith_sponge_run.argtypes = [
        ctypes.c_void_p,  # fctx
        ctypes.c_int32,   # t
        ctypes.c_int32,   # rounds
        ctypes.c_int32,   # bars
        ctypes.c_int32,   # n_bits
        ctypes.c_int32,   # bar_m
        ctypes.c_int32,   # rate
        ctypes.c_int32,   # capacity
        ctypes.c_void_p,  # rc
        ctypes.c_void_p,  # concrete
        ctypes.c_void_p,  # r2
        ctypes.c_void_p,  # steps
        ctypes.c_int64,   # n_steps
        ctypes.c_void_p,  # elems
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # state_io
        ctypes.c_void_p,  # bk
    ]
    return lib


def get_poseidon_lib() -> Optional[ctypes.CDLL]:
    """The native host Poseidon runtime (csrc/poseidon_host.cc), or None."""
    global _POSEIDON_LIB, _POSEIDON_TRIED
    if _POSEIDON_TRIED:
        return _POSEIDON_LIB
    with _LOCK:
        if not _POSEIDON_TRIED:
            _POSEIDON_LIB = _build_poseidon()
            _POSEIDON_TRIED = True
    return _POSEIDON_LIB


def _field_ctx(fs) -> np.ndarray:
    """p ‖ c_enc ‖ c_dec ‖ n0inv as 32-bit words.

    The native word-CIOS radix is R_c = 2^256; the device limb radix is
    R_dev = 2^(12*22) = 2^264.  c_enc = R_c*R_dev mod p maps canonical -> device
    Montgomery form in one native multiply; c_dec = R_c/R_dev mod p maps back.
    """
    p = fs.modulus
    r_c = 1 << 256
    r_dev = fs.r
    ctx = np.zeros(25, dtype=np.uint32)
    ctx[0:8] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint32)
    ctx[8:16] = np.frombuffer(
        (r_c * r_dev % p).to_bytes(32, "little"), dtype=np.uint32
    )
    ctx[16:24] = np.frombuffer(
        (r_c * pow(r_dev, -1, p) % p).to_bytes(32, "little"), dtype=np.uint32
    )
    ctx[24] = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return ctx


def encode_mont_plane_native(fs, values_le: bytes, n: int) -> Optional[np.ndarray]:
    """n canonical 32-byte-LE values -> (L, n) int32 device Montgomery plane.

    The radix conversion (native word radix 2^256 vs device limb radix 2^264)
    is folded into the encode/decode multipliers in ``_field_ctx``.
    """
    lib = get_lib()
    if lib is None or fs.nlimbs != 22 or fs.limb_bits != 12:
        return None
    out = np.empty((22, n), dtype=np.int32)
    buf = np.frombuffer(values_le, dtype=np.uint8)
    ctx = _field_ctx(fs)
    lib.encode_mont_plane(
        buf.ctypes.data, n, ctx.ctypes.data, out.ctypes.data
    )
    return out


def decode_mont_plane_native(fs, plane: np.ndarray) -> Optional[bytes]:
    """(L, n) int32 *native-R* Montgomery plane -> n canonical 32-byte-LE values."""
    lib = get_lib()
    if lib is None or fs.nlimbs != 22 or fs.limb_bits != 12:
        return None
    plane = np.ascontiguousarray(plane, dtype=np.int32)
    n = plane.shape[1]
    out = np.empty(n * 32, dtype=np.uint8)
    ctx = _field_ctx(fs)
    lib.decode_mont_plane(plane.ctypes.data, n, ctx.ctypes.data, out.ctypes.data)
    return out.tobytes()


def pack_bytes_to_elements_native(fs, data: bytes):
    """Byte stream -> list of ints via the native 31-byte chunk packer,
    or None for the pure-python fallback."""
    lib = get_lib()
    chunk = (fs.modulus_bit_size - 1) // 8
    if lib is None or chunk > 32 or not data:
        return None  # python fallback handles these (incl. empty -> [])
    n = (len(data) + chunk - 1) // chunk
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(n * 32, dtype=np.uint8)
    lib.pack_bytes_to_elements(buf.ctypes.data, len(data), chunk, out.ctypes.data)
    raw = out.tobytes()
    return [
        int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(n)
    ]
