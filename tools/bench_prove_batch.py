"""Batched vs single Groth16 proving rate on falcon-512 verify-NTT.

Builds K distinct satisfying assignments with the device witness engine
(the aggregate-sig shape: one CRS, K signatures), then times
prove_batch(K) against K sequential prove() calls.

Run: python tools/bench_prove_batch.py [K] [iters]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

# host-C prove bench: witness generation runs on the CPU; the timed path
# is the native prover
jax.config.update("jax_platforms", "cpu")

import numpy as np

import falcon_r1cs_tpu as fr
from falcon_r1cs_tpu.falcon import make_instance, ntt
from falcon_r1cs_tpu.params import FALCON_512
from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
from falcon_r1cs_tpu.snark import prove, prove_batch, setup, verify
from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk
from falcon_r1cs_tpu.snark.points import ints_to_limbs
from falcon_r1cs_tpu.witness import interleave_witness, jitted_engine
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()


def build_assignments(K: int, n: int = 512):
    rng = np.random.default_rng(7)
    insts = [make_instance(rng, fr.get_params(n)) for _ in range(K)]
    sig = np.stack([i.sig_lifted for i in insts]).astype(np.int32)
    pk_ntt = np.stack([ntt(i.h) for i in insts]).astype(np.int32)
    hm_ntt = np.stack([ntt(i.hm) for i in insts]).astype(np.int32)
    run = jitted_engine(n)
    seg = {k: np.asarray(v) for k, v in run(sig, pk_ntt, hm_ntt).items()}
    wit = interleave_witness(seg, FALCON_512)
    assignments, publics = [], []
    for k in range(K):
        pub = [1] + [int(v) for v in seg["pk_ntt"][k]] + [
            int(v) for v in seg["hm_ntt"][k]
        ]
        z = pub + [int(v) for v in wit[k]]
        assignments.append(ints_to_limbs(z, 4))
        publics.append(pub)
    return assignments, publics


def main():
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    n = 512
    rng = np.random.default_rng(5)
    inst = make_instance(rng, fr.get_params(n))
    compiled = compile_circuit(fr.FalconNTTVerificationCircuit, inst)
    crs = cache_dir() / f"FalconNTTVerificationCircuit_{n}.pk.npz"
    if crs.exists():
        pk = load_pk(crs)
    else:
        pk = setup(compiled)
        save_pk(pk, crs)
    assignments, publics = build_assignments(K, n)

    # warm native build + point caches
    prove_batch(pk, compiled, assignments[:2])

    t0 = time.perf_counter()
    p = None
    for _ in range(iters):
        p = prove(pk, compiled, assignments[0])
    t_single = (time.perf_counter() - t0) / iters
    assert verify(pk.vk, publics[0], p)

    t0 = time.perf_counter()
    proofs = None
    for _ in range(iters):
        proofs = prove_batch(pk, compiled, assignments)
    t_batch = (time.perf_counter() - t0) / iters
    for k in range(K):
        assert verify(pk.vk, publics[k], proofs[k]), k

    print(f"single prove:        {t_single*1e3:8.1f} ms  "
          f"({1/t_single:5.2f} proofs/s)")
    print(f"batch K={K:<3d}:        {t_batch*1e3:8.1f} ms  "
          f"({K/t_batch:5.2f} proofs/s, {t_batch/K*1e3:6.1f} ms/proof)")
    print(f"speedup vs K singles: {t_single*K/t_batch:5.2f}x")


if __name__ == "__main__":
    main()
