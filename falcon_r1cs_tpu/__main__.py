"""Command-line entry: python -m falcon_r1cs_tpu <command>.

Commands map onto the reference's executables and this framework's
additions (the reference exposes `cargo run --example constraint_counts`
and `--example pok_sig`; `/root/reference/falcon-r1cs/examples/`):

  counts           golden constraint-count table, both parameter sets
  pok-sig [n]      keygen -> sign -> synthesize -> witness -> sat-check
                   -> Groth16 setup/prove/verify   (512 or 1024)
  aggregate ...    batched wire-bytes -> witness -> sat verdict
  selftest         golden drive: counts + satisfiability for verify-512
  verify ...       batched signature verification on device (demo on
                   freshly generated instances)
"""

from __future__ import annotations

import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent


def _with_repo_path():
    # the examples live beside the package in the source tree
    if str(_REPO) not in sys.path:
        sys.path.insert(0, str(_REPO))


def _selftest() -> int:
    import numpy as np

    import falcon_r1cs_tpu as fr
    from falcon_r1cs_tpu.falcon import make_instance

    rng = np.random.default_rng(0)
    inst = make_instance(rng, fr.get_params(512))
    cs = fr.ConstraintSystem()
    fr.FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(
        cs
    )
    golden = (1025, 78386, 81460)
    got = (
        cs.num_instance_variables,
        cs.num_witness_variables,
        cs.num_constraints,
    )
    ok = got == golden and cs.is_satisfied()
    print(f"verify-512 counts {got} vs golden {golden}; satisfied={ok}")
    return 0 if ok else 1


def _verify_demo(k: int = 8) -> int:
    import numpy as np

    from falcon_r1cs_tpu.falcon import make_instance, verify_batch
    from falcon_r1cs_tpu.params import FALCON_512

    rng = np.random.default_rng(0)
    insts = [make_instance(rng, FALCON_512, msg=b"m%d" % i) for i in range(k)]
    h = np.stack([i.h for i in insts])
    s2 = np.stack([i.sig_signed for i in insts])
    msgs = [i.msg for i in insts]
    msgs[-1] = b"tampered"
    out = verify_batch(h, msgs, [i.nonce for i in insts], s2, FALCON_512)
    print(f"batched device verification ({k} sigs, last tampered):",
          out.tolist())
    return 0 if out[:-1].all() and not out[-1] else 1


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    _with_repo_path()
    from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if cmd == "counts":
        sys.argv = ["constraint_counts.py", *rest]
        from examples.constraint_counts import main as counts_main

        counts_main()
        return 0
    if cmd == "pok-sig":
        sys.argv = ["pok_sig.py", *rest]
        from examples.pok_sig import main as pok_main

        pok_main()
        return 0
    if cmd == "aggregate":
        sys.argv = ["aggregate_sig.py", *rest]
        import examples.aggregate_sig as agg

        agg.main()
        return 0
    if cmd == "selftest":
        return _selftest()
    if cmd == "verify":
        return _verify_demo(int(rest[0]) if rest else 8)
    print(f"unknown command {cmd!r}\n")
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
