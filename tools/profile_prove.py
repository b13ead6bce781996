"""Per-stage timing of a falcon-512 Groth16 prove (host + native C).

Run: python tools/profile_prove.py [iters]
Prints the witness-map / per-MSM / assembly split that motivates the
batched msm_multi design.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import falcon_r1cs_tpu as fr
from falcon_r1cs_tpu.falcon import make_instance
from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
from falcon_r1cs_tpu.snark import native_backend, setup
from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk, prove, verify
from falcon_r1cs_tpu.snark.points import ints_to_limbs
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    n = 512
    rng = np.random.default_rng(5)
    inst = make_instance(rng, fr.get_params(n))
    compiled = compile_circuit(fr.FalconNTTVerificationCircuit, inst)
    cs = fr.ConstraintSystem(mode="prove")
    fr.FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(cs)
    assignment = list(cs.instance_values) + list(cs.witness_values)
    crs = cache_dir() / f"FalconNTTVerificationCircuit_{n}.pk.npz"
    if crs.exists():
        pk = load_pk(crs)
    else:
        pk = setup(compiled)
        save_pk(pk, crs)
    z_limbs = ints_to_limbs([int(x) for x in assignment], 4)
    assert native_backend.available()

    # warm (builds .so, converts points to Montgomery, caches)
    prove(pk, compiled, z_limbs)

    ni = compiled.num_instance

    def timed(label, f, *a):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(*a)
        dt = (time.perf_counter() - t0) / iters
        print(f"{label:26s} {dt*1e3:9.1f} ms")
        return out

    h, top = timed("witness_map", native_backend.witness_map, compiled,
                   np.ascontiguousarray(z_limbs, dtype=np.uint64))
    z = np.ascontiguousarray(z_limbs, dtype=np.uint64)
    timed("msm A (a_query)", native_backend.g1_msm, pk.a_query, z)
    timed("msm B1 (b_g1_query)", native_backend.g1_msm, pk.b_g1_query, z)
    timed("msm B2 (b_g2_query, G2)", native_backend.g2_msm, pk.b_g2_query, z)
    timed("msm L (l_query)", native_backend.g1_msm, pk.l_query, z[ni:])
    timed("msm H (h_query)", native_backend.g1_msm, pk.h_query, h)
    timed("prove (total)", prove, pk, compiled, z_limbs)


if __name__ == "__main__":
    main()
