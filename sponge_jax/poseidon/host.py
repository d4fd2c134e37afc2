"""Native host-runtime Poseidon sponge (C++ backend, bit-exact vs the oracle).

The reference sponge's production consumers are split: provers hash huge batches
(device path), while verifiers / transcript checkers run a handful of permutations
on a CPU where a device dispatch round trip dwarfs the arithmetic.  The
reference serves the latter with ark-ff's native Montgomery backend
(/root/reference/src/test.rs:10, ``MontBackend<.., 4>``); this module is the
framework's equivalent: a scalar 4x64-bit Montgomery CIOS permutation and a
whole-schedule duplex driver in C++ (csrc/poseidon_host.cc), loaded via ctypes.

Two tiers:

* :class:`HostPoseidonSponge` — a drop-in ``OraclePoseidonSponge`` whose
  ``permute`` runs natively.  Every oracle API (absorb codec, squeeze
  bytes/bits/nonnative, fork, SpongeExt) is inherited unchanged, so it is
  bit-exact by construction everywhere except the permutation, which is tested
  against the oracle.  ~100-1000x the pure-python oracle.
* :func:`host_run_schedule` — runs an entire absorb/squeeze schedule (the same
  step language as ``transcript.compile_transcript``) in ONE native call,
  including the duplex mode-flip and no-permute-squeeze quirks
  (/root/reference/src/poseidon/mod.rs:121-182).  This is the host analogue of
  the compiled-transcript device path, for latency-bound verifier loops.

Both degrade gracefully: without a C++ toolchain (or for >256-bit or
non-uint32-alpha configs) ``HostPoseidonSponge`` falls back to the pure oracle
and ``host_run_schedule`` raises ``RuntimeError`` (callers check
:func:`host_available`).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from ..utils.native import get_poseidon_lib
from .config import PoseidonConfig
from .oracle import ABSORBING, SQUEEZING, OraclePoseidonSponge, SpongeState

_R_BITS = 256  # native word radix: 4 x 64-bit limbs
_R = 1 << _R_BITS


def _supported(cfg: PoseidonConfig) -> bool:
    p = cfg.field.modulus
    if _is_monolith(cfg):
        # Bars run on a single canonical u64 word in the native runtime.
        return p % 2 == 1 and p.bit_length() <= 64
    return (
        p % 2 == 1
        and p.bit_length() <= _R_BITS
        and 1 <= cfg.alpha < (1 << 31)
    )


def host_available(cfg: PoseidonConfig) -> bool:
    """True when the native runtime can serve this config."""
    return _supported(cfg) and get_poseidon_lib() is not None


@dataclass(frozen=True)
class _HostTables:
    """Per-config native constants: field ctx + Montgomery-form ark/mds."""

    fctx: np.ndarray  # (5,) u64: p (4 LE words) + n0inv
    ark: np.ndarray   # (R*t*4,) u64, Montgomery
    mds: np.ndarray   # (t*t*4,) u64, Montgomery
    opt: np.ndarray   # packed sparse-MDS optimized-partial tables, or None

    @property
    def opt_ptr(self) -> int:
        return 0 if self.opt is None else self.opt.ctypes.data


def _to_mont_words(p: int, values) -> np.ndarray:
    """Canonical ints -> (n, 4) u64 LE Montgomery-form words."""
    buf = bytearray()
    for v in values:
        buf += ((v << _R_BITS) % p).to_bytes(32, "little")
    return np.frombuffer(bytes(buf), dtype=np.uint64).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _rinv(p: int) -> int:
    return pow(_R, -1, p)


def _from_mont_words(p: int, words: np.ndarray) -> list:
    """(n, 4) u64 LE Montgomery-form words -> canonical ints."""
    rinv = _rinv(p)
    raw = np.ascontiguousarray(words, dtype=np.uint64).tobytes()
    return [
        int.from_bytes(raw[i : i + 32], "little") * rinv % p
        for i in range(0, len(raw), 32)
    ]


@dataclass(frozen=True)
class _HostTables2:
    """Per-config native Poseidon2 constants (csrc Poseidon2Tables layout)."""

    fctx: np.ndarray  # (5,) u64: p (4 LE words) + n0inv
    ext: np.ndarray   # (R_F*t*4,) u64, Montgomery
    intr: np.ndarray  # (R_P*4,) u64, Montgomery (or 1 dummy word row)
    mat_e: np.ndarray  # (t*t,) int32 small plain ints
    diag: np.ndarray  # (t*4,) u64, Montgomery form of (mu_i - 1)
    diag_small: np.ndarray  # (t,) int32 plain (mu_i - 1), or None

    @property
    def diag_small_ptr(self) -> int:
        return 0 if self.diag_small is None else self.diag_small.ctypes.data


@functools.lru_cache(maxsize=32)
def _tables2(cfg) -> _HostTables2:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    ext = _to_mont_words(p, [a for row in cfg.external_rc for a in row]).reshape(-1)
    intr = _to_mont_words(p, cfg.internal_rc or [0]).reshape(-1)
    mat_e = np.ascontiguousarray(np.asarray(cfg.mat_e, dtype=np.int32).reshape(-1))
    dm1 = [(d - 1) % p for d in cfg.mat_i_diag]
    diag = _to_mont_words(p, dm1).reshape(-1)
    diag_small = (
        np.ascontiguousarray(np.asarray(dm1, dtype=np.int32))
        if all(v < (1 << 20) for v in dm1)
        else None
    )
    return _HostTables2(
        fctx=fctx, ext=ext, intr=intr, mat_e=mat_e, diag=diag,
        diag_small=diag_small,
    )


def _is_p2(cfg) -> bool:
    from ..poseidon2.config import Poseidon2Config

    return isinstance(cfg, Poseidon2Config)


def _is_monolith(cfg) -> bool:
    from ..monolith.config import MonolithConfig

    return isinstance(cfg, MonolithConfig)


def _is_rescue(cfg) -> bool:
    from ..rescue.config import RescueConfig

    return isinstance(cfg, RescueConfig)


def _is_griffin(cfg) -> bool:
    from ..griffin.config import GriffinConfig

    return isinstance(cfg, GriffinConfig)


def _is_anemoi(cfg) -> bool:
    from ..anemoi.config import AnemoiConfig

    return isinstance(cfg, AnemoiConfig)


def _is_gmimc(cfg) -> bool:
    from ..gmimc.config import GmimcConfig

    return isinstance(cfg, GmimcConfig)


@dataclass(frozen=True)
class _HostTablesGm:
    """Per-config native GMiMC-erf constants (csrc GmimcTables layout)."""

    fctx: np.ndarray  # (5,) u64: p (4 LE words) + n0inv
    rc: np.ndarray    # (rounds*4,) u64, Montgomery


@functools.lru_cache(maxsize=32)
def _tablesgm(cfg) -> _HostTablesGm:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    rc = _to_mont_words(p, list(cfg.rc)).reshape(-1)
    return _HostTablesGm(fctx=fctx, rc=rc)


@dataclass(frozen=True)
class _HostTablesA:
    """Per-config native Anemoi constants (csrc AnemoiTables layout)."""

    fctx: np.ndarray      # (5,) u64: p (4 LE words) + n0inv
    rc_x: np.ndarray      # (rounds*l*4,) u64, Montgomery
    rc_y: np.ndarray      # (rounds*l*4,) u64, Montgomery
    mat: np.ndarray       # (l*l*4,) u64, Montgomery
    g: np.ndarray         # (4,) u64, Montgomery
    g_inv: np.ndarray     # (4,) u64, Montgomery
    inv_alpha: np.ndarray  # (4,) u64 LE: plain exponent 1/alpha mod (p-1)
    one_mont: np.ndarray  # (4,) u64: Montgomery form of 1


@functools.lru_cache(maxsize=32)
def _tablesa(cfg) -> _HostTablesA:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    rc_x = _to_mont_words(p, [a for row in cfg.rc_x for a in row]).reshape(-1)
    rc_y = _to_mont_words(p, [a for row in cfg.rc_y for a in row]).reshape(-1)
    mat = _to_mont_words(p, [m for row in cfg.mat_x for m in row]).reshape(-1)
    g = _to_mont_words(p, [cfg.g]).reshape(-1)
    g_inv = _to_mont_words(p, [cfg.g_inv]).reshape(-1)
    inv_alpha = np.ascontiguousarray(
        np.frombuffer(cfg.inv_alpha.to_bytes(32, "little"), dtype=np.uint64)
    )
    one_mont = np.ascontiguousarray(
        np.frombuffer((_R % p).to_bytes(32, "little"), dtype=np.uint64)
    )
    return _HostTablesA(
        fctx=fctx, rc_x=rc_x, rc_y=rc_y, mat=mat, g=g, g_inv=g_inv,
        inv_alpha=inv_alpha, one_mont=one_mont,
    )


@dataclass(frozen=True)
class _HostTablesG:
    """Per-config native Griffin constants (csrc GriffinTables layout)."""

    fctx: np.ndarray      # (5,) u64: p (4 LE words) + n0inv
    rc: np.ndarray        # ((rounds-1)*t*4,) u64, Montgomery (dummy if empty)
    mat_e: np.ndarray     # (t*t,) int32 small plain ints
    qa: np.ndarray        # ((t-2)*4,) u64, Montgomery alpha_i
    qb: np.ndarray        # ((t-2)*4,) u64, Montgomery beta_i
    inv_alpha: np.ndarray  # (4,) u64 LE: plain exponent 1/alpha mod (p-1)
    one_mont: np.ndarray  # (4,) u64: Montgomery form of 1


@functools.lru_cache(maxsize=32)
def _tablesg(cfg) -> _HostTablesG:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    rc_flat = [a for row in cfg.rc for a in row]
    rc = _to_mont_words(p, rc_flat or [0]).reshape(-1)
    mat_e = np.ascontiguousarray(
        np.asarray(cfg.mat_e, dtype=np.int32).reshape(-1)
    )
    coeffs = [cfg.quad_coeffs(i) for i in range(2, cfg.t)]
    qa = _to_mont_words(p, [a for a, _ in coeffs]).reshape(-1)
    qb = _to_mont_words(p, [b for _, b in coeffs]).reshape(-1)
    inv_alpha = np.ascontiguousarray(
        np.frombuffer(cfg.inv_alpha.to_bytes(32, "little"), dtype=np.uint64)
    )
    one_mont = np.ascontiguousarray(
        np.frombuffer((_R % p).to_bytes(32, "little"), dtype=np.uint64)
    )
    return _HostTablesG(
        fctx=fctx, rc=rc, mat_e=mat_e, qa=qa, qb=qb,
        inv_alpha=inv_alpha, one_mont=one_mont,
    )


@dataclass(frozen=True)
class _HostTablesR:
    """Per-config native Rescue-Prime constants (csrc RescueTables layout)."""

    fctx: np.ndarray      # (5,) u64: p (4 LE words) + n0inv
    rc: np.ndarray        # (2*rounds*t*4,) u64, Montgomery
    mds: np.ndarray       # (t*t*4,) u64, Montgomery
    inv_alpha: np.ndarray  # (4,) u64 LE: plain exponent 1/alpha mod (p-1)
    one_mont: np.ndarray  # (4,) u64: Montgomery form of 1


@functools.lru_cache(maxsize=32)
def _tablesr(cfg) -> _HostTablesR:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    rc = _to_mont_words(p, [a for row in cfg.rc for a in row]).reshape(-1)
    mds = _to_mont_words(p, [m for row in cfg.mds for m in row]).reshape(-1)
    inv_alpha = np.ascontiguousarray(
        np.frombuffer(cfg.inv_alpha.to_bytes(32, "little"), dtype=np.uint64)
    )
    one_mont = np.ascontiguousarray(
        np.frombuffer((_R % p).to_bytes(32, "little"), dtype=np.uint64)
    )
    return _HostTablesR(
        fctx=fctx, rc=rc, mds=mds, inv_alpha=inv_alpha, one_mont=one_mont
    )


def _bar_m(fs) -> int:
    """The Bar chunk boundary the native runtime passes to ``bar_u64``
    (single source: ``monolith.config.bar_m``)."""
    from ..monolith.config import bar_m

    return bar_m(fs)


@dataclass(frozen=True)
class _HostTablesM:
    """Per-config native Monolith constants (csrc MonolithTables layout)."""

    fctx: np.ndarray      # (5,) u64: p (4 LE words) + n0inv
    rc: np.ndarray        # (rounds*t*4,) u64, Montgomery (last row zero)
    concrete: np.ndarray  # (t*t*4,) u64, Montgomery
    r2: np.ndarray        # (4,) u64: R^2 mod p (to-Montgomery factor)


@functools.lru_cache(maxsize=32)
def _tablesm(cfg) -> _HostTablesM:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    rc = _to_mont_words(p, [a for row in cfg.rc for a in row]).reshape(-1)
    concrete = _to_mont_words(
        p, [v for row in cfg.concrete for v in row]
    ).reshape(-1)
    r2 = np.ascontiguousarray(
        np.frombuffer(((_R * _R) % p).to_bytes(32, "little"), dtype=np.uint64)
    )
    return _HostTablesM(fctx=fctx, rc=rc, concrete=concrete, r2=r2)


def _call_permute(lib, cfg, plane: np.ndarray, n: int, n_threads: int,
                  tab=None) -> None:
    """Dispatch the native batch permute on the config family (in-place).

    ``tab``: pre-resolved table bundle (``_tables``/``_tables2`` result) — pass
    it on per-permute hot paths to skip the lru_cache lookup, which hashes the
    whole config (63x3 bigint ark tuple) and costs ~4% of a native permute.
    """
    if _is_gmimc(cfg):
        tab = tab if tab is not None else _tablesgm(cfg)
        lib.gmimc_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            tab.rc.ctypes.data, plane.ctypes.data, n, n_threads,
        )
    elif _is_anemoi(cfg):
        tab = tab if tab is not None else _tablesa(cfg)
        lib.anemoi_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            tab.rc_x.ctypes.data, tab.rc_y.ctypes.data, tab.mat.ctypes.data,
            tab.g.ctypes.data, tab.g_inv.ctypes.data,
            tab.inv_alpha.ctypes.data, tab.one_mont.ctypes.data,
            plane.ctypes.data, n, n_threads,
        )
    elif _is_griffin(cfg):
        tab = tab if tab is not None else _tablesg(cfg)
        lib.griffin_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            tab.rc.ctypes.data, tab.mat_e.ctypes.data,
            tab.qa.ctypes.data, tab.qb.ctypes.data,
            tab.inv_alpha.ctypes.data, tab.one_mont.ctypes.data,
            plane.ctypes.data, n, n_threads,
        )
    elif _is_rescue(cfg):
        tab = tab if tab is not None else _tablesr(cfg)
        lib.rescue_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            tab.rc.ctypes.data, tab.mds.ctypes.data,
            tab.inv_alpha.ctypes.data, tab.one_mont.ctypes.data,
            plane.ctypes.data, n, n_threads,
        )
    elif _is_monolith(cfg):
        tab = tab if tab is not None else _tablesm(cfg)
        lib.monolith_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.rounds, cfg.bars,
            cfg.field.modulus_bit_size, _bar_m(cfg.field),
            tab.rc.ctypes.data, tab.concrete.ctypes.data, tab.r2.ctypes.data,
            plane.ctypes.data, n, n_threads,
        )
    elif _is_p2(cfg):
        tab = tab if tab is not None else _tables2(cfg)
        lib.poseidon2_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.full_rounds,
            cfg.partial_rounds, tab.ext.ctypes.data, tab.intr.ctypes.data,
            tab.mat_e.ctypes.data, tab.diag.ctypes.data, tab.diag_small_ptr,
            plane.ctypes.data, n, n_threads,
        )
    else:
        tab = tab if tab is not None else _tables(cfg)
        lib.poseidon_permute_host(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.full_rounds,
            cfg.partial_rounds, tab.ark.ctypes.data, tab.mds.ctypes.data,
            tab.opt_ptr, plane.ctypes.data, n, n_threads,
        )


@functools.lru_cache(maxsize=32)
def _tables(cfg: PoseidonConfig) -> _HostTables:
    p = cfg.field.modulus
    fctx = np.zeros(5, dtype=np.uint64)
    fctx[0:4] = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64)
    fctx[4] = (-pow(p, -1, 1 << 64)) % (1 << 64)
    ark = _to_mont_words(p, [a for row in cfg.ark for a in row]).reshape(-1)
    mds = _to_mont_words(p, [m for row in cfg.mds for m in row]).reshape(-1)
    opt = None
    if cfg.partial_rounds >= 2:
        # Same exact-identity sparse decomposition the device tiers use —
        # 2t-1 products per partial round instead of t^2.
        from .optimized import optimized_partial_layers

        lay = optimized_partial_layers(cfg)
        flat = list(lay.c_first)
        for row in lay.constants:
            flat.extend(row)
        for sp in lay.sparse:
            flat.extend(sp.row0)
        for sp in lay.sparse:
            flat.extend(sp.col0)
        for row in lay.dense:
            flat.extend(row)
        opt = np.ascontiguousarray(_to_mont_words(p, flat).reshape(-1))
    return _HostTables(fctx=fctx, ark=ark, mds=mds, opt=opt)


def host_permute_states(cfg: PoseidonConfig, states, n_threads: int = 0) -> list:
    """Permute ``n`` canonical-int states (flat list of n*t ints) natively.

    ``n_threads``: worker threads for the batch; 0 = auto (one per core for
    large batches, single-threaded for small ones).  Returns the permuted flat
    list.  Raises ``RuntimeError`` when the native runtime is unavailable
    (callers should gate on :func:`host_available`).
    """
    lib = get_poseidon_lib()
    if lib is None or not _supported(cfg):
        raise RuntimeError("native host Poseidon runtime unavailable")
    t = cfg.t
    n, rem = divmod(len(states), t)
    if rem:
        raise ValueError(f"states length {len(states)} not a multiple of t={t}")
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16) if n >= 64 else 1
    plane = np.ascontiguousarray(_to_mont_words(cfg.field.modulus, states))
    _call_permute(lib, cfg, plane, n, n_threads)
    return _from_mont_words(cfg.field.modulus, plane)


class HostPoseidonSponge(OraclePoseidonSponge):
    """Oracle-API sponge whose permutation runs in the native C++ runtime.

    State stays canonical python ints (so ``SpongeExt``/clone/fork and every
    squeeze-formatting path are inherited verbatim); only ``permute`` crosses
    into C++.  Falls back to the pure-python permutation when the native
    library cannot be built, so constructing one never fails.
    """

    def __init__(self, cfg: PoseidonConfig):
        super().__init__(cfg)
        self._native = host_available(cfg)
        # Resolve tables/lib once: hashing the config (63x3 bigint ark tuple)
        # per permute would cost a measurable fraction of the permutation.
        if self._native:
            if _is_gmimc(cfg):
                self._tab = _tablesgm(cfg)
            elif _is_anemoi(cfg):
                self._tab = _tablesa(cfg)
            elif _is_griffin(cfg):
                self._tab = _tablesg(cfg)
            elif _is_rescue(cfg):
                self._tab = _tablesr(cfg)
            elif _is_monolith(cfg):
                self._tab = _tablesm(cfg)
            elif _is_p2(cfg):
                self._tab = _tables2(cfg)
            else:
                self._tab = _tables(cfg)
        else:
            self._tab = None
        self._lib = get_poseidon_lib() if self._native else None

    def permute(self):
        if not self._native:
            return super().permute()
        cfg = self.cfg
        plane = np.ascontiguousarray(
            _to_mont_words(cfg.field.modulus, self.state)
        )
        _call_permute(self._lib, cfg, plane, 1, 1, tab=self._tab)
        self.state = _from_mont_words(cfg.field.modulus, plane)

    def clone(self):
        new = type(self)(self.cfg)
        new.state = list(self.state)
        new.mode = self.mode
        new.index = self.index
        return new


from ..anemoi.oracle import OracleAnemoiSponge  # noqa: E402
from ..gmimc.oracle import OracleGmimcSponge  # noqa: E402
from ..griffin.oracle import OracleGriffinSponge  # noqa: E402
from ..monolith.oracle import OracleMonolithSponge  # noqa: E402
from ..poseidon2.oracle import OraclePoseidon2Sponge  # noqa: E402
from ..rescue.oracle import OracleRescueSponge  # noqa: E402


class HostPoseidon2Sponge(HostPoseidonSponge, OraclePoseidon2Sponge):
    """The Poseidon2 oracle with the native permute.

    MRO (HostPoseidonSponge, OraclePoseidon2Sponge): ``permute`` resolves to
    the native dispatcher (``_call_permute`` selects the Poseidon2 C++ entry
    by config family) and its pure-python fallback ``super().permute()``
    resolves to the Poseidon2 oracle schedule.
    """


class HostMonolithSponge(HostPoseidonSponge, OracleMonolithSponge):
    """The Monolith oracle with the native permute (same MRO pattern)."""


class HostRescueSponge(HostPoseidonSponge, OracleRescueSponge):
    """The Rescue-Prime oracle with the native permute (same MRO pattern)."""


class HostGriffinSponge(HostPoseidonSponge, OracleGriffinSponge):
    """The Griffin oracle with the native permute (same MRO pattern)."""


class HostAnemoiSponge(HostPoseidonSponge, OracleAnemoiSponge):
    """The Anemoi oracle with the native permute (same MRO pattern)."""


class HostGmimcSponge(HostPoseidonSponge, OracleGmimcSponge):
    """The GMiMC-erf oracle with the native permute (same MRO pattern)."""


_MODE_CODE = {ABSORBING: 0, SQUEEZING: 1}
_MODE_NAME = {0: ABSORBING, 1: SQUEEZING}


def host_run_schedule(cfg, steps, elems, state: SpongeState = None):
    """Run a whole absorb/squeeze schedule in one native call.

    ``steps``: sequence of ``("absorb", n)`` / ``("squeeze", n)`` pairs —
    absorbs consume the next ``n`` canonical ints from ``elems``, squeezes emit
    ``n`` native field elements.  ``state``: resume point (a ``SpongeState``
    from a previous run / ``into_state()``); None starts a fresh sponge.

    Returns ``(squeezed, new_state)`` with ``squeezed`` the concatenated
    canonical-int outputs in schedule order.  Matches the reference duplex
    state machine exactly (mod.rs:232-341), including zero-element absorbs
    being no-ops and the remaining==rate squeeze quirk.
    """
    lib = get_poseidon_lib()
    if lib is None or not _supported(cfg):
        raise RuntimeError("native host Poseidon runtime unavailable")
    p = cfg.field.modulus

    n_absorb = sum(n for kind, n in steps if kind == "absorb")
    n_squeeze = sum(n for kind, n in steps if kind == "squeeze")
    elems = list(elems)
    if len(elems) != n_absorb:
        raise ValueError(
            f"schedule absorbs {n_absorb} elements, got {len(elems)}"
        )

    step_arr = np.zeros((max(len(steps), 1), 2), dtype=np.int32)
    for i, (kind, n) in enumerate(steps):
        if kind == "absorb":
            step_arr[i] = (0, n)
        elif kind == "squeeze":
            step_arr[i] = (1, n)
        else:
            raise ValueError(f"unknown step kind {kind!r}")

    ein = np.ascontiguousarray(
        _to_mont_words(p, [e % p for e in elems])
        if elems
        else np.zeros((1, 4), dtype=np.uint64)
    )
    out = np.zeros((max(n_squeeze, 1), 4), dtype=np.uint64)
    if state is None:
        state = SpongeState(state=[0] * cfg.t, mode=ABSORBING, index=0)
    st = np.ascontiguousarray(_to_mont_words(p, state.state))
    bk = np.array([_MODE_CODE[state.mode], state.index], dtype=np.int32)

    if _is_gmimc(cfg):
        tab = _tablesgm(cfg)
        lib.gmimc_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            cfg.rate, cfg.capacity, tab.rc.ctypes.data,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )
    elif _is_anemoi(cfg):
        tab = _tablesa(cfg)
        lib.anemoi_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            cfg.rate, cfg.capacity,
            tab.rc_x.ctypes.data, tab.rc_y.ctypes.data, tab.mat.ctypes.data,
            tab.g.ctypes.data, tab.g_inv.ctypes.data,
            tab.inv_alpha.ctypes.data, tab.one_mont.ctypes.data,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )
    elif _is_griffin(cfg):
        tab = _tablesg(cfg)
        lib.griffin_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            cfg.rate, cfg.capacity,
            tab.rc.ctypes.data, tab.mat_e.ctypes.data,
            tab.qa.ctypes.data, tab.qb.ctypes.data,
            tab.inv_alpha.ctypes.data, tab.one_mont.ctypes.data,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )
    elif _is_rescue(cfg):
        tab = _tablesr(cfg)
        lib.rescue_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.rounds,
            cfg.rate, cfg.capacity,
            tab.rc.ctypes.data, tab.mds.ctypes.data,
            tab.inv_alpha.ctypes.data, tab.one_mont.ctypes.data,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )
    elif _is_monolith(cfg):
        tab = _tablesm(cfg)
        lib.monolith_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.rounds, cfg.bars,
            cfg.field.modulus_bit_size, _bar_m(cfg.field),
            cfg.rate, cfg.capacity,
            tab.rc.ctypes.data, tab.concrete.ctypes.data, tab.r2.ctypes.data,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )
    elif _is_p2(cfg):
        tab = _tables2(cfg)
        lib.poseidon2_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.full_rounds,
            cfg.partial_rounds, cfg.rate, cfg.capacity,
            tab.ext.ctypes.data, tab.intr.ctypes.data,
            tab.mat_e.ctypes.data, tab.diag.ctypes.data, tab.diag_small_ptr,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )
    else:
        tab = _tables(cfg)
        lib.poseidon_sponge_run(
            tab.fctx.ctypes.data, cfg.t, cfg.alpha, cfg.full_rounds,
            cfg.partial_rounds, cfg.rate, cfg.capacity,
            tab.ark.ctypes.data, tab.mds.ctypes.data, tab.opt_ptr,
            step_arr.ctypes.data, len(steps),
            ein.ctypes.data, out.ctypes.data, st.ctypes.data, bk.ctypes.data,
        )

    squeezed = _from_mont_words(p, out)[:n_squeeze]
    new_state = SpongeState(
        state=_from_mont_words(p, st),
        mode=_MODE_NAME[int(bk[0])],
        index=int(bk[1]),
    )
    return squeezed, new_state
