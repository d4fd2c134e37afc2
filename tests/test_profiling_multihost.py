"""Profiling utilities + multi-host helpers (single-process, 8 virtual devices)."""

import numpy as np

import jax

from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
from sponge_jax.parallel.multihost import global_mesh, initialize, scaling_report
from sponge_jax.utils.profiling import ThroughputMeter, op_counts, sbox_muls


CFG = get_default_poseidon_parameters(BLS12_381_FR, 2, False)


def test_sbox_muls():
    assert sbox_muls(5) == 3
    assert sbox_muls(17) == 5
    assert sbox_muls(257) == 9


def test_op_counts():
    c = op_counts(CFG)
    # rate-2 constraints-opt: R_F=8, R_P=31, t=3, alpha=17
    assert c["rounds"] == 39
    assert c["sbox_applications"] == 8 * 3 + 31
    assert c["field_muls"] == 55 * 5 + 39 * 9
    assert c["r1cs_constraints_per_permutation"] == 5 * 55
    assert c["int32_muls_cios_per_lane"] > 0


def test_throughput_meter():
    from sponge_jax.poseidon.permutation import permute_jit, zero_state

    meter = ThroughputMeter(reps=2)
    rate = meter.measure(permute_jit(CFG), zero_state(CFG, 16))
    assert rate > 0


def test_kernel_op_census():
    """Exact jaxpr op census: element counts, scan trip multiplication, and
    nested-jaxpr recursion (the measurement behind DESIGN §7's roofline finding)."""
    import jax.numpy as jnp

    from sponge_jax.utils.profiling import kernel_op_census

    shape = jax.ShapeDtypeStruct((4, 8), jnp.int32)

    c = kernel_op_census(lambda x: x * x + x, shape)
    assert c["mul"] == 32 and c["add"] == 32

    def scanned(x):
        def body(carry, _):
            return carry * x, None

        out, _ = jax.lax.scan(body, x, None, length=5)
        return out

    c = kernel_op_census(scanned, shape)
    assert c["mul"] == 5 * 32

    # the census sees through the XLA tier's round loops (tiny field)
    from conftest import tiny_poseidon_config

    from sponge_jax.poseidon.permutation import permute_jit

    tcfg = tiny_poseidon_config()
    B = 128
    census = kernel_op_census(
        permute_jit(tcfg),
        jax.ShapeDtypeStruct((tcfg.t, tcfg.field.nlimbs, B), jnp.int32),
    )
    per_lane = {k: v / B for k, v in census.items()}
    # L=4-limb products x (sbox_apps*sbox_muls + MDS): the exact count is the
    # tier's to choose, but it must be in the hundreds per lane and integral
    # (whole vector ops per lane).
    assert 100 < per_lane["mul"] < 20000, per_lane
    assert per_lane["mul"] == int(per_lane["mul"])


def test_initialize_single_process_noop():
    initialize()  # must not raise without cluster args


def test_scaling_report_virtual_mesh():
    assert global_mesh().devices.size == 8
    report = scaling_report(CFG, batch_per_device=8, reps=1)
    assert report["devices"] == 8
    assert report["perms_per_sec"] > 0


def test_scaling_report_parity_gate_refuses(monkeypatch):
    """The scaling harness obeys the repo-wide refuse-to-report rule
    (VERDICT r3 Weak #5): a kernel that does not reproduce the oracle must
    raise, not emit a throughput number."""
    import pytest
    from conftest import tiny_poseidon_config

    import sponge_jax.parallel.sharded as sharded_mod

    real = sharded_mod.sharded_permute_fn

    def corrupted(cfg, mesh, backend="auto"):
        fn = real(cfg, mesh, backend)

        def bad(state):
            return fn(state).at[0, 0, :].add(1)

        return bad

    monkeypatch.setattr(sharded_mod, "sharded_permute_fn", corrupted)
    with pytest.raises(RuntimeError, match="PARITY FAILURE"):
        scaling_report(tiny_poseidon_config(), batch_per_device=8, reps=1)
