"""The one dispatch point, the Merkle pad, the compile cache, chip_smoke.py.

Every permutation family runs its XLA tier on every platform; this file pins
the XLA tier of Poseidon against the oracle over a matrix of small configs,
the errors for backend names that do not exist (the fused kernels of the
first platform are gone, and nothing interprets one on a machine without
it), the Merkle pad that keeps the narrow tail on one compiled shape, the
compile-cache placement, and ``chip_smoke.py``'s phases at tiny sizes and
its refusal without a GPU.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import TINY_FR, TINY_FR_45, check_permutation_vs_oracle, tiny_poseidon_config

from sponge_jax.poseidon import permutation as perm

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---- the XLA tier vs the oracle over small configs ----


@pytest.mark.parametrize("alpha", [3, 5, 17], ids=["a3", "a5", "a17"])
@pytest.mark.parametrize("t", [2, 3, 4], ids=["t2", "t3", "t4"])
@pytest.mark.parametrize("field", [TINY_FR, TINY_FR_45], ids=["tiny35", "tiny45"])
def test_xla_tier_matches_oracle(field, t, alpha):
    """Full and partial rounds, every width the main path uses, each S-box
    degree of the shipped tables; lane 1 carries p - 1."""
    cfg = tiny_poseidon_config(
        t=t, field=field, full_rounds=4, partial_rounds=4, alpha=alpha, seed=t
    )
    check_permutation_vs_oracle(cfg, B=96, stride=11, seed=t)


def test_auto_backend_is_the_xla_tier():
    cfg = tiny_poseidon_config()
    rng = np.random.default_rng(9)
    state = jnp.asarray(
        rng.integers(0, 1 << 12, size=(cfg.t, cfg.field.nlimbs, 64)), jnp.int32
    ).at[:, -1, :].set(0)
    auto = perm.batched_permute(cfg, state)
    assert np.array_equal(np.asarray(auto), np.asarray(perm.permute_jit(cfg)(state)))
    assert np.array_equal(np.asarray(auto), np.asarray(perm.batched_permute(cfg, state, "xla")))


def _p2_config():
    from conftest import tiny_poseidon2_config

    return tiny_poseidon2_config()


@pytest.mark.parametrize("backend", ["cios", "pallas", "mosaic", "triton"])
def test_unknown_backend_refused(backend):
    """The fused kernels' names are gone with the kernels; nothing falls back
    to an interpreted kernel."""
    cfg = tiny_poseidon_config()
    state = jnp.zeros((cfg.t, cfg.field.nlimbs, 128), jnp.int32)
    with pytest.raises(ValueError, match="unknown backend"):
        perm.batched_permute(cfg, state, backend=backend)


def _family_configs():
    """One config per non-Poseidon family (cheap constructions)."""
    from sponge_jax import (
        BLS12_381_FR,
        GOLDILOCKS_FR,
        MERSENNE31_FR,
        get_default_anemoi_parameters,
        get_default_gmimc_parameters,
        get_default_griffin_parameters,
        get_default_monolith_parameters,
        get_default_rescue_parameters,
    )

    return {
        "poseidon2": lambda: _p2_config(),
        "rescue": lambda: get_default_rescue_parameters(GOLDILOCKS_FR, 4),
        "monolith": lambda: get_default_monolith_parameters(MERSENNE31_FR, 8),
        "griffin": lambda: get_default_griffin_parameters(BLS12_381_FR, 2),
        "anemoi": lambda: get_default_anemoi_parameters(BLS12_381_FR, 1),
        "gmimc": lambda: get_default_gmimc_parameters(GOLDILOCKS_FR, 4),
    }


@pytest.mark.parametrize(
    "family", ["poseidon2", "rescue", "monolith", "griffin", "anemoi", "gmimc"]
)
def test_family_kernel_backends_refused(family):
    """Every family runs its XLA tier on every platform and refuses a kernel
    backend by name instead of interpreting one."""
    cfg = _family_configs()[family]()
    state = jnp.zeros((cfg.t, cfg.field.nlimbs, 128), jnp.int32)
    for backend in ("cios", "pallas", f"{family}_pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            perm.batched_permute(cfg, state, backend=backend)


# ---- the Merkle pad: one compiled shape for the narrow tail ----


@pytest.mark.parametrize("log_leaves", [5, 6, 9], ids=["2^5", "2^6", "2^9"])
def test_merkle_narrow_levels_pad_to_chunk(monkeypatch, log_leaves):
    """Every level narrower than ``chunk`` is padded up to it, so a whole tree
    compiles one permutation shape per wide level plus one for the tail; the
    root still equals the oracle's reduction."""
    from sponge_jax import hash as h

    cfg = tiny_poseidon_config()
    fs = cfg.field
    N, chunk = 1 << log_leaves, 16
    widths = []
    real = h.compress_pairs

    def spy(cfg_, left, right, backend="auto"):
        widths.append(left.shape[-1])
        return real(cfg_, left, right, backend)

    monkeypatch.setattr(h, "compress_pairs", spy)
    rng = np.random.default_rng(log_leaves)
    vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=N)]
    root = h.merkle_root(cfg, jnp.asarray(fs.ints_to_mont_plane(vals)), chunk=chunk)
    assert set(widths) == {chunk}
    level = vals
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = cfg.oracle_sponge()
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    assert fs.mont_limbs_to_int(np.asarray(root)) % fs.modulus == level[0]


# ---- compile-cache placement ----


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_env_dir_wins(monkeypatch, tmp_path, restore_cache_config):
    from sponge_jax.utils import jaxcache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.configure_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set.
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    from sponge_jax.utils import jaxcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.configure_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored and "chiprun_out/" in ignored


# ---- chip_smoke.py: phases at tiny sizes, refusal without a GPU ----


@pytest.fixture
def smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_smoke_permutation_phase(smoke, capsys):
    cfg = tiny_poseidon_config()
    smoke.phase_permutation(smoke.Clock("test card"), cfg, 8, lanes=8)
    out = capsys.readouterr().out
    assert "8 sampled lanes match the oracle" in out
    assert "memory_analysis" in out and "[test card]" in out


def test_smoke_merkle_phase(smoke, capsys):
    smoke.phase_merkle(smoke.Clock("test card"), tiny_poseidon_config(), 6, n_open=16)
    assert "16 openings verify" in capsys.readouterr().out


def test_smoke_transcript_phase(smoke, capsys):
    smoke.phase_transcript(
        smoke.Clock("test card"), tiny_poseidon_config(), 64, sponge_lanes=4, checked=4
    )
    out = capsys.readouterr().out
    assert "transcript: 4 sampled lanes match" in out and "lazy sponge: bytes" in out


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_smoke_refuses_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_sharded_phase(smoke, capsys):
    """The --four phase on four of the virtual CPU devices, tiny sizes."""
    cfg = tiny_poseidon_config()
    smoke.phase_sharded(
        smoke.Clock("test card"), n_devices=4, log_batch=5, log_leaves=7, lanes=16,
        cfgs=(cfg, cfg),
    )
    out = capsys.readouterr().out
    assert "sharded permutation == one card" in out
    assert "sharded Merkle root == one card" in out
    assert "sharded transcript == one card" in out
