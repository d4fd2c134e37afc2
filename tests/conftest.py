"""Test configuration: a deterministic 8-device CPU mesh, or the card.

The suite runs on the CPU, where multi-device sharding is validated on
virtual devices (``--xla_force_host_platform_device_count=8``, SURVEY.md §4)
and the GPU kernel runs through the Pallas interpreter.  Tests marked
``gpu`` need the card: they skip here (the ``gpu`` fixture decides at run
time) and run on the card through ``python chip_smoke.py``, which selects
them with ``-m gpu`` inside its own process.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402


def pytest_configure(config):
    """Pin the CPU platform unless this run selects the card-only tests.

    Decided from the marker expression the run asked for, never from what
    hardware is present, so every xdist worker configures the same way."""
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


# NO persistent compilation cache for the test suite.  Three full-suite runs
# on this box died to segfaults inside the cache's XLA-executable
# (de)serialization — `executable.serialize()` on the put path and
# `backend.deserialize_executable(...)` on the get path (jax 0.9.0 CPU
# backend; small executables serialize fine, the multi-MB unrolled kernel
# programs are the suspects).  Disabling zstd compression did not help (the
# crash is below the compression layer), so the suite runs cache-less:
# in-memory jit caching still covers repeated configs within a run, and a
# cold run costs ~45-60 min either way.  The GPU scripts (bench/,
# chip_smoke.py) keep theirs (utils/jaxcache.py).

import gc as _gc  # noqa: E402
import pathlib as _pathlib  # noqa: E402

import numpy as _np  # noqa: E402
import pytest as _pytest  # noqa: E402

from sponge_jax.fields import FieldSpec  # noqa: E402
from sponge_jax.poseidon.config import PoseidonConfig  # noqa: E402

# ---------------------------------------------------------------------------
# Fast/slow lanes (VERDICT r4 Weak #1): the `slow` marker is applied at
# per-test granularity from the FROZEN, measured list tests/slow_tests.txt
# (node ids >= 20 s in the tools/time_tests.sh campaign; regenerate with
# tools/slow_tests_from_logs.py --emit).  The default `pytest tests/` lane
# excludes them via addopts `-m 'not slow'` (pyproject.toml); run everything
# with `pytest tests/ -m ''`.  Every component keeps fast-lane coverage —
# the marked ids are the compile-heavy variants (big batches, many schedule
# points), not whole modules.
# ---------------------------------------------------------------------------

_SLOW_IDS = frozenset(
    line.strip()
    for line in (_pathlib.Path(__file__).parent / "slow_tests.txt")
    .read_text()
    .splitlines()
    if line.strip() and not line.startswith("#")
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in _SLOW_IDS:
            item.add_marker(_pytest.mark.slow)


@_pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled-executable state between test modules.

    A full single-process suite run accumulates hundreds of XLA-CPU
    compilations (some multi-MB unrolled kernel programs); two full-suite
    runs died to SIGABRT *inside* ``backend_compile_and_load`` deep into the
    run while the same test passes standalone — cumulative compiler state,
    not any single program, is the trigger.  Dropping jax's in-process
    caches at each module boundary keeps the hot intra-module reuse (the
    expensive tiny-field kernel bodies are compiled and reused within one
    module) while bounding what a 395-test run accumulates."""
    yield
    import jax

    jax.clear_caches()
    _gc.collect()

# Tiny test field (~35-bit prime, 4 limbs instead of 22).  Exists so the fully
# unrolled CIOS kernel *body* — whose XLA-CPU compile at L=22 takes hours — can
# be executed end-to-end in default CI in seconds (trace size scales ~L^2).
# No cryptographic significance; parity-critical semantics are still exercised
# (same round schedule, same CIOS/REDC/sparse-opt code paths).
TINY_FR = FieldSpec(name="tiny_fr_35", modulus=(1 << 35) - 31, generator=3)

# Second tiny field at a different limb count (4 limbs vs 3): the kernel config
# fuzzer (test_fuzz_kernel_configs.py) draws over both so column-count-dependent
# bookkeeping (schoolbook width 2L, REDC chain length) is exercised at two L.
TINY_FR_45 = FieldSpec(name="tiny_fr_45", modulus=(1 << 45) - 55, generator=3)


def tiny_poseidon_config(
    t: int = 3,
    full_rounds: int = 4,
    partial_rounds: int = 3,
    alpha: int = 5,
    seed: int = 7,
    field: FieldSpec = TINY_FR,
) -> PoseidonConfig:
    """Deterministic small Poseidon config over TINY_FR.

    ark/mds are seeded-random residues (mds invertibility holds for this seed —
    asserted by the sparse-opt factorization itself); the matrix need not be MDS
    for kernel-parity tests.
    """
    rng = _np.random.default_rng(seed)
    p = field.modulus
    rounds = full_rounds + partial_rounds

    def draw():
        return int(rng.integers(0, 1 << 62)) % p

    ark = tuple(tuple(draw() for _ in range(t)) for _ in range(rounds))
    mds = tuple(tuple(draw() for _ in range(t)) for _ in range(t))
    return PoseidonConfig(
        field=field,
        full_rounds=full_rounds,
        partial_rounds=partial_rounds,
        alpha=alpha,
        ark=ark,
        mds=mds,
        rate=t - 1,
        capacity=1,
    )


def tiny_poseidon2_config(
    rate: int = 2,
    alpha: int = 5,
    full_rounds: int = 4,
    partial_rounds: int = 8,
):
    """Deterministic small Poseidon2 config over TINY_FR (real Grain-derived
    constants — exercises the production parameter-generation path).

    The tiny field's small R/p headroom makes element values hit the
    Montgomery radix within a few internal rounds, so these configs exercise
    the Poseidon2 XLA tier's rho-folding hard."""
    from sponge_jax.poseidon2 import generate_poseidon2_parameters

    return generate_poseidon2_parameters(
        TINY_FR, rate, alpha, full_rounds, partial_rounds
    )


@_pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.

    Decided when the test runs, never at import or collection, so every
    xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _pytest.skip("needs the GPU: run on the card through `python chip_smoke.py`")
    return dev


def check_permutation_vs_oracle(cfg, B=64, stride=7, seed=0, backend="xla"):
    """``batched_permute(cfg, ·, backend)`` on ``B`` random lanes (lanes 0 and
    1 hold the edge values 0 and p - 1) vs the family's scalar oracle on
    every ``stride``-th lane."""
    from sponge_jax.poseidon.permutation import batched_permute

    fs = cfg.field
    rng = _np.random.default_rng(seed)
    vals = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=B)]
        for _ in range(cfg.t)
    ]
    vals[0][0] = 0
    vals[0][1] = fs.modulus - 1
    state = _np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    out = _np.asarray(batched_permute(cfg, state, backend))
    for b in [0, 1, *range(2, B, stride)]:
        o = cfg.oracle_sponge()
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [fs.mont_limbs_to_int(out[i][:, b]) % fs.modulus for i in range(cfg.t)]
        assert got == [v % fs.modulus for v in o.state], (cfg.field.name, b)
