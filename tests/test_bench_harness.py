"""Unit tests for bench/_harness.py's measurement protocol.

The harness is the single source of timing discipline for bench.py,
full_bench and chip_smoke.py (one UNTIMED warm window, then best-of-N timed
windows, each ending in ``block_until_ready``).  These tests pin the
protocol itself: call counts, warm-window exclusion, best-of selection, the
device-made random planes, lane sampling, the oracle gate's refusal, and the
refusal to run without a GPU.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "bench"))

from _harness import time_perms, timed_best

from conftest import tiny_poseidon_config


def test_timed_best_warm_window_excluded():
    """The first (warm) call's rate must not be reported; best of the
    remaining windows is."""
    rates = iter([1.0, 5.0, 3.0, 4.0])
    calls = []

    def window():
        r = next(rates)
        calls.append(r)
        return r

    assert timed_best(window, windows=3) == 5.0
    assert calls == [1.0, 5.0, 3.0, 4.0]  # 1 warm + 3 timed


def test_time_perms_call_counts_and_chaining():
    """time_perms must run (1 + windows) windows of `iters` chained calls,
    restarting each timed window from the first output."""
    calls = []

    class FakeState:
        def __init__(self, tag):
            self.tag = tag

        def __getitem__(self, idx):
            return np.zeros(8)

    def fn(state):
        calls.append(state.tag)
        return FakeState(state.tag + 1)

    first = FakeState(0)
    rate = time_perms(fn, first, B=128, iters=4, windows=2)
    assert rate > 0
    # 1 warm + 2 timed windows, each 4 chained calls starting from tag 0.
    assert len(calls) == 12
    assert calls[0::4] == [0, 0, 0]  # every window restarts from first_out
    assert calls[:4] == [0, 1, 2, 3]  # and chains within the window


def test_random_mont_plane_is_canonical_and_seeded():
    from _harness import random_mont_plane

    fs = tiny_poseidon_config().field
    a = np.asarray(random_mont_plane(fs, (3, 256), seed=5))
    assert a.shape == (3, fs.nlimbs, 256) and a.dtype == np.int32
    assert a.min() >= 0 and a.max() <= fs.limb_mask
    vals = [fs.limbs_to_int(a[i][:, b]) for i in range(3) for b in range(256)]
    assert max(vals) < fs.modulus and len(set(vals)) > 700
    assert np.array_equal(a, np.asarray(random_mont_plane(fs, (3, 256), seed=5)))
    assert not np.array_equal(a, np.asarray(random_mont_plane(fs, (3, 256), seed=6)))


@pytest.mark.parametrize("B,n", [(2, 64), (100, 10), (1 << 20, 64)])
def test_sample_lanes_spans_the_batch(B, n):
    from _harness import sample_lanes

    lanes = sample_lanes(B, n)
    assert lanes[0] == 0 and lanes[-1] == B - 1
    assert len(lanes) == min(n, B) and lanes == sorted(set(lanes))


def test_check_lanes_refuses_a_wrong_lane():
    from sponge_jax.poseidon.permutation import batched_permute

    from _harness import check_lanes, random_mont_plane

    cfg = tiny_poseidon_config()
    state = random_mont_plane(cfg.field, (cfg.t, 32), seed=1)
    out = batched_permute(cfg, state)
    assert check_lanes(cfg, state, out, n=8) == 8
    with pytest.raises(RuntimeError, match="PARITY FAILURE"):
        check_lanes(cfg, state, out.at[1, 0, 31].add(1), n=8)


def test_require_gpu_refuses_the_cpu():
    from _harness import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_timed_calls_waits_for_each_call():
    import jax.numpy as jnp

    from _harness import timed_calls

    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(4) * len(calls)

    times = timed_calls(fn, 3)
    assert len(times) == 3 and len(calls) == 4 and all(t >= 0 for t in times)


def test_card_info_joins_cards(monkeypatch):
    import subprocess

    import _harness

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Done())
    assert _harness.card_info() == (
        "NVIDIA H100 80GB HBM3, 700.00 W; NVIDIA H100 80GB HBM3, 700.00 W"
    )
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: (_ for _ in ()).throw(OSError()))
    assert _harness.card_info() == "nvidia-smi unavailable (OSError)"
