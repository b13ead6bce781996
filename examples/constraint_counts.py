"""Golden-count benchmark: the analog of the reference's
`examples/constraint_counts.rs` (`/root/reference/falcon-r1cs/examples/
constraint_counts.rs:12-138`), printing the same table for BOTH parameter
sets in one run (runtime config instead of cargo features).

    python examples/constraint_counts.py [--n 512|1024]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from falcon_r1cs_tpu import (
    ConstraintSystem,
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
    Q,
)
from falcon_r1cs_tpu.circuits import const_q_power_vars
from falcon_r1cs_tpu.falcon import make_instance, ntt
from falcon_r1cs_tpu.gadgets import NTTPolyVar, PolyVar, ntt_param_var
from falcon_r1cs_tpu.params import get_params
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache


def count_ntt_conversion(params, rng):
    cs = ConstraintSystem()
    param_vars = ntt_param_var(cs, params)
    poly = rng.integers(0, Q, size=params.n)
    poly_var = PolyVar.alloc_vars(cs, poly, "witness")
    const_vars = const_q_power_vars(cs, params)
    before = cs.counters()
    out = NTTPolyVar.ntt_circuit(cs, poly_var, const_vars, param_vars, params)
    after = cs.counters()
    clear = ntt(poly)
    assert [v._val() for v in out.coeff()] == [int(x) for x in clear]
    assert cs.is_satisfied()
    return tuple(a - b for a, b in zip(after, before))


def count_circuit(cls, inst):
    cs = ConstraintSystem()
    cls.build_circuit(inst).generate_constraints(cs)
    assert cs.is_satisfied()
    return cs.counters()


def section_breakdown(inst):
    """Per-section counter demo (the aux-subsystem replacement for the
    reference's commented-out println probes, SURVEY.md section 5)."""
    from falcon_r1cs_tpu.utils.counters import CounterLog
    from falcon_r1cs_tpu.gadgets import enforce_less_than_q
    from falcon_r1cs_tpu.r1cs import FpVar

    cs = ConstraintSystem()
    log = CounterLog(cs)
    params = inst.params
    with log.section("constants"):
        const_q_power_vars(cs, params)
        ntt_param_var(cs, params)
    with log.section("alloc sig"):
        sig_var = PolyVar.alloc_vars(cs, inst.sig_lifted, "witness")
    with log.section("range proofs (one coeff)"):
        enforce_less_than_q(cs, sig_var.coeff()[0])
    return log.table()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, choices=(512, 1024), default=None)
    args = ap.parse_args()
    configure_compile_cache()
    ns = [args.n] if args.n else [512, 1024]
    rng = np.random.default_rng(0)
    for n in ns:
        params = get_params(n)
        inst = make_instance(rng, params)
        print(f"Falcon-{n}:        # instance variables |      # witness |      #constraints |")
        rows = [
            ("ntt conversion", count_ntt_conversion(params, rng)),
            ("verify with ntt", count_circuit(FalconNTTVerificationCircuit, inst)),
            ("verify with dual ntt", count_circuit(FalconDualNTTVerificationCircuit, inst)),
            ("verify with schoolbook", count_circuit(FalconSchoolBookVerificationCircuit, inst)),
        ]
        for name, (i, w, c) in rows:
            print(f"{name:22s} {i:20} | {w:14} | {c:17} |")
        print()
        print(section_breakdown(inst))
        print()


if __name__ == "__main__":
    main()
