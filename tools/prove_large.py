"""Groth16 end-to-end at the reference's FULL envelope:
schoolbook-1024 (1,156,150 constraints — domain 2^21) and dual-1024.

The reference proves any circuit x parameter set by flipping a cargo
feature (/root/reference/falcon-r1cs/examples/pok_sig.rs:30-47 +
falcon-r1cs/Cargo.toml:28-32); this drives the two combinations round 2
never ran, with stage timings.

Run: JAX_PLATFORMS=cpu python tools/prove_large.py [schoolbook|dual] [--save-crs]
(CPU JAX: witness generation at batch 1 is fast everywhere; the prove
path is host C.)
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

# witness generation at batch 1 is fast on the CPU; the prove path is
# host C
jax.config.update("jax_platforms", "cpu")

import numpy as np

import falcon_r1cs_tpu as fr
from falcon_r1cs_tpu.falcon import make_instance, ntt
from falcon_r1cs_tpu.params import FALCON_1024
from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
from falcon_r1cs_tpu.snark import prove, setup, verify
from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk
from falcon_r1cs_tpu.snark.points import ints_to_limbs
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()


def timed(label, f, *a, **k):
    t0 = time.perf_counter()
    out = f(*a, **k)
    print(f"{label:22s} {time.perf_counter() - t0:8.1f} s", flush=True)
    return out


def run(which: str, save_crs: bool = False):
    n = 1024
    rng = np.random.default_rng(9)
    inst = make_instance(rng, fr.get_params(n))
    if which == "schoolbook":
        from falcon_r1cs_tpu.witness import (
            interleave_witness_schoolbook as interleave,
            jitted_engine_schoolbook as engine,
        )

        cls = fr.FalconSchoolBookVerificationCircuit
        sig = inst.sig_lifted[None].astype(np.int32)
        pk_in = inst.h[None].astype(np.int32)
        hm_in = inst.hm[None].astype(np.int32)
    else:
        from falcon_r1cs_tpu.witness import (
            interleave_witness_dual as interleave,
            jitted_engine_dual as engine,
        )

        cls = fr.FalconDualNTTVerificationCircuit
        sig = inst.sig_signed[None].astype(np.int32)
        pk_in = ntt(inst.h)[None].astype(np.int32)
        hm_in = ntt(inst.hm)[None].astype(np.int32)

    compiled = timed("compile (direct COO)", compile_circuit, cls, inst)
    print(f"  constraints={compiled.num_constraints} "
          f"instance={compiled.num_instance}", flush=True)
    seg = {k: np.asarray(v) for k, v in engine(n)(sig, pk_in, hm_in).items()}
    wit = interleave(seg, FALCON_1024)
    publics = [1] + [int(v) for v in pk_in[0]] + [int(v) for v in hm_in[0]]
    assignment = ints_to_limbs(publics + [int(v) for v in wit[0]], 4)

    crs_path = cache_dir() / f"{cls.__name__}_{n}.pk.npz"
    if crs_path.exists():
        pk = timed("load CRS", load_pk, crs_path)
    else:
        pk = timed("setup (CRS)", setup, compiled)
        if save_crs:
            timed("save CRS", save_pk, pk, crs_path)
    proof = timed("prove (cold)", prove, pk, compiled, assignment)
    timed("prove (warm)", prove, pk, compiled, assignment)
    ok = timed("verify", verify, pk.vk, publics, proof)
    assert ok, "proof rejected"
    bad = list(publics)
    bad[1] = (bad[1] + 1) % 12289
    assert not verify(pk.vk, bad, proof), "tamper accepted"
    print(f"{which}-1024: prove+verify GREEN, tamper rejected", flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "schoolbook"
    run(which, save_crs="--save-crs" in sys.argv)
