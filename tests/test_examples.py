"""Smoke-execute every example in examples/ (VERDICT r4 Weak #6).

The examples are the README's advertised entry points; nothing else executes
them, so they would rot silently.  Each runs in a fresh subprocess pinned to
the CPU backend (``JAX_PLATFORMS=cpu``), and the test asserts exit 0 plus the
example's load-bearing output line (the challenge-match / verify line, not
just any output).

All three run CONCURRENTLY so the default-lane wall cost is the slowest
example (~1 min, dominated by the L=22 XLA-CPU transcript compile in
fiat_shamir), not the sum.  Three JAX processes at once are fine on the CPU;
the pin keeps them off a GPU, where each would reserve most of the card.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# example file -> substring its output must contain for the run to count as
# semantically successful (each is printed only after an equality check
# against the oracle / native verifier inside the example).
EXPECTED = {
    "fiat_shamir.py": "challenges match the device transcript lane",
    "merkle_commitment.py": "opened+verified 32 proofs",
    "family_tour.py": "GMiMC-erf / Goldilocks: challenge=",
}

def test_examples_execute_and_verify():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # examples run single-device
    procs = {}
    for name in EXPECTED:
        procs[name] = subprocess.Popen(
            [sys.executable, str(REPO / "examples" / name)],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
    failures = []
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            failures.append(f"{name}: TIMEOUT\n{err[-1000:]}")
            continue
        if proc.returncode != 0:
            failures.append(f"{name}: rc={proc.returncode}\n{err[-2000:]}")
        elif EXPECTED[name] not in out:
            failures.append(f"{name}: missing expected line\n{out[-1000:]}")
    assert not failures, "\n\n".join(failures)
