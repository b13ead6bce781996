"""Batched Groth16 proving at the reference's LARGE circuits: dual-1024 and schoolbook-1024 with K >= 8 proofs over one CRS.

The interesting part is memory + task-grid behavior: schoolbook-1024's
h_query has 2^21 points, so the K-fold MSM buffers (K x num_vars u64
limb matrices, K-wide digit-recode planes) are ~10x the falcon-512
shapes the batched prover was first measured on.

Run: python tools/bench_prove_batch_large.py [dual|schoolbook] [K]
(forces CPU jax for witness generation; prove path is host C.)
"""


import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import falcon_r1cs_tpu as fr
from falcon_r1cs_tpu.falcon import make_instance, ntt
from falcon_r1cs_tpu.params import FALCON_1024
from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
from falcon_r1cs_tpu.snark import prove, setup, verify
from falcon_r1cs_tpu.snark.groth16 import load_pk, prove_batch, save_pk
from falcon_r1cs_tpu.snark.points import ints_to_limbs
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()


def timed(label, f, *a, **k):
    t0 = time.perf_counter()
    out = f(*a, **k)
    print(f"{label:24s} {time.perf_counter() - t0:8.1f} s", flush=True)
    return out


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "schoolbook"
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    n = 1024
    rng = np.random.default_rng(11)
    insts = [make_instance(rng, fr.get_params(n)) for _ in range(K)]

    if which == "schoolbook":
        from falcon_r1cs_tpu.witness import (
            interleave_witness_schoolbook as interleave,
            jitted_engine_schoolbook as engine,
        )

        cls = fr.FalconSchoolBookVerificationCircuit
        sig = np.stack([i.sig_lifted for i in insts]).astype(np.int32)
        pk_in = np.stack([i.h for i in insts]).astype(np.int32)
        hm_in = np.stack([i.hm for i in insts]).astype(np.int32)
    else:
        from falcon_r1cs_tpu.witness import (
            interleave_witness_dual as interleave,
            jitted_engine_dual as engine,
        )

        cls = fr.FalconDualNTTVerificationCircuit
        sig = np.stack([i.sig_signed for i in insts]).astype(np.int32)
        pk_in = np.stack([ntt(i.h) for i in insts]).astype(np.int32)
        hm_in = np.stack([ntt(i.hm) for i in insts]).astype(np.int32)

    compiled = timed("compile (direct COO)", compile_circuit, cls, insts[0])
    print(f"  constraints={compiled.num_constraints} "
          f"vars={compiled.num_variables}", flush=True)
    seg = {k: np.asarray(v) for k, v in engine(n)(sig, pk_in, hm_in).items()}
    wit = timed("interleave K witnesses", interleave, seg, FALCON_1024)
    publics, assignments = [], []
    for k in range(K):
        pub = [1] + [int(v) for v in pk_in[k]] + [int(v) for v in hm_in[k]]
        publics.append(pub)
        assignments.append(
            ints_to_limbs(pub + [int(v) for v in wit[k]], 4)
        )

    crs_path = cache_dir() / f"{cls.__name__}_{n}.pk.npz"
    if crs_path.exists():
        pk = timed("load CRS", load_pk, crs_path)
    else:
        pk = timed("setup (CRS)", setup, compiled)
        cache_dir().mkdir(parents=True, exist_ok=True)
        timed("save CRS", save_pk, pk, crs_path)

    prove_batch(pk, compiled, assignments[:2])  # warm build + point caches

    # interleaved single / batch / single (host-drift-cancelling ratio)
    t0 = time.perf_counter()
    p0 = prove(pk, compiled, assignments[0])
    t_s0 = time.perf_counter() - t0
    t0 = time.perf_counter()
    proofs = prove_batch(pk, compiled, assignments)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1 = prove(pk, compiled, assignments[1 % K])
    t_s1 = time.perf_counter() - t0
    t_single = (t_s0 + t_s1) / 2

    assert verify(pk.vk, publics[0], p0)
    assert verify(pk.vk, publics[1 % K], p1)
    for k in range(K):
        assert verify(pk.vk, publics[k], proofs[k]), k
    bad = list(publics[0])
    bad[1] = (bad[1] + 1) % 12289
    assert not verify(pk.vk, bad, proofs[0])

    import resource

    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"single prove:         {t_single:8.2f} s")
    print(f"batch K={K:<3d}:         {t_batch:8.2f} s "
          f"({t_batch / K:6.2f} s/proof)")
    print(f"speedup vs K singles: {t_single * K / t_batch:5.2f}x")
    print(f"peak RSS:             {peak_gb:8.2f} GB")
    print(f"{which}-1024 batch K={K}: all proofs verify, tamper rejected",
          flush=True)


if __name__ == "__main__":
    main()
