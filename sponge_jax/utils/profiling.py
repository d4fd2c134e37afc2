"""Tracing / profiling / metrics for sponge workloads.

The reference's only observability is ``tracing`` spans on every R1CS gadget
method (SURVEY.md §5; the reference's src/poseidon/constraints.rs:38ff).  The
device-side equivalents here:

* ``trace``: context manager around ``jax.profiler`` producing a TensorBoard-
  compatible trace directory (the analogue of attaching a tracing subscriber);
* ``annotate``: named scope so kernels show up with readable names in traces;
* ``ThroughputMeter``: permutations/sec counter, each window ending in
  ``block_until_ready``;
* ``op_counts``: static per-permutation arithmetic cost model of each kernel
  tier — the counter the reference exposes as R1CS constraint counts, recast
  for performance accounting.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import jax

from ..poseidon.config import PoseidonConfig


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed block (view in TensorBoard/
    Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


annotate = jax.named_scope


@dataclass
class ThroughputMeter:
    """Measures sustained permutations/sec of a state->state step function."""

    reps: int = 8

    def measure(self, step_fn, state) -> float:
        out = jax.block_until_ready(step_fn(state))
        t0 = time.perf_counter()
        for _ in range(self.reps):
            out = step_fn(out)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / self.reps
        return out.shape[-1] / dt


def sbox_muls(alpha: int) -> int:
    """Field multiplies per S-box application (square-and-multiply chain)."""
    bits = bin(alpha)[2:]
    return (len(bits) - 1) + bits[1:].count("1")


def kernel_op_census(fn, *arg_shapes) -> dict:
    """EXACT per-element ALU-op counts of a traced function, by jaxpr walk.

    Traces ``fn`` over ``arg_shapes`` (jax.ShapeDtypeStruct, or arrays) and
    sums the element counts of every elementwise integer ALU primitive,
    recursing into nested jaxprs (kernel bodies, scan bodies
    multiplied by their trip count).  This is measurement, not modeling — the
    companion to ``op_counts``'s static estimate.  Divides a measured rate into integer ops/s for a roofline.

    Returns {primitive_name: total_output_elements}; divide by the batch/tile
    width for per-lane counts.
    """
    _COUNTED = {
        "mul", "add", "sub", "and", "or", "xor", "shift_left",
        "shift_right_logical", "shift_right_arithmetic", "select_n", "ne",
        "eq", "lt", "ge", "gt", "le", "max", "min",
    }
    jaxpr = jax.make_jaxpr(fn)(*arg_shapes)
    counts: dict = {}

    def walk(jx, mult):
        for eqn in jx.eqns:
            prim = eqn.primitive.name
            if prim in _COUNTED:
                shape = eqn.outvars[0].aval.shape
                n = 1
                for s in shape:
                    n *= int(s)
                counts[prim] = counts.get(prim, 0) + n * mult
            inner_mult = mult
            if prim == "scan":
                inner_mult = mult * int(eqn.params.get("length", 1))
            for v in eqn.params.values():
                for item in v if isinstance(v, (list, tuple)) else [v]:
                    if hasattr(item, "jaxpr") and hasattr(item.jaxpr, "eqns"):
                        walk(item.jaxpr, inner_mult)
                    elif hasattr(item, "eqns"):
                        walk(item, inner_mult)

    walk(jaxpr.jaxpr, 1)
    return counts


def op_counts(cfg: PoseidonConfig) -> dict:
    """Static per-permutation arithmetic accounting for ``cfg``.

    ``field_muls`` counts Montgomery multiplies exactly as the scalar reference
    performs them (mod.rs:95-118); ``int32_muls_cios`` models the 32-bit
    multiply count per lane of an interleaved-CIOS implementation (schoolbook
    2L^2-ish per field mul, MDS rows sharing reductions;
    ``kernel_op_census`` measures the true emitted counts of a traced
    program).
    """
    L = cfg.field.nlimbs
    t = cfg.t
    s = sbox_muls(cfg.alpha)
    sbox_apps = cfg.full_rounds * t + cfg.partial_rounds
    field_muls = sbox_apps * s + cfg.rounds * t * t  # sbox + MDS
    # Interleaved CIOS: per field-mul ~ L^2 (schoolbook) + (L-1)^2-ish (REDC);
    # per MDS row: t*L^2 products + one REDC.
    redc = sum(1 for pk in cfg.field.int_to_limbs(cfg.field.modulus) if pk) * L
    per_mul = L * L + redc
    mds_per_round = t * (t * L * L + redc)
    int32_muls = sbox_apps * s * per_mul + cfg.rounds * mds_per_round
    return {
        "rounds": cfg.rounds,
        "sbox_applications": sbox_apps,
        "sbox_muls_each": s,
        "field_muls": field_muls,
        "int32_muls_cios_per_lane": int32_muls,
        "r1cs_constraints_per_permutation": s * sbox_apps,
    }
