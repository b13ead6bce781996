"""Batched aggregate verification: the realization of the reference's empty
`falcon-aggregate-sig` workspace stub
(`/root/reference/falcon-aggregate-sig/src/main.rs:1-3` is "Hello, world!").

K wire-format (pk, msg, sig) triples -> one device pass producing, for every
signature, the full R1CS witness of the verify-with-NTT circuit, the packed
canonical export, and a batched CRT satisfiability verdict.

    python examples/aggregate_sig.py [--k 64] [--n 512]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from falcon_r1cs_tpu import FalconNTTVerificationCircuit
from falcon_r1cs_tpu.falcon import (
    compress_signature,
    encode_public_key,
    make_instance,
)
from falcon_r1cs_tpu.params import get_params
from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem
from falcon_r1cs_tpu.pipeline import ProverInputPipeline
from falcon_r1cs_tpu.r1cs.coo import compile_circuit
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--n", type=int, choices=(512, 1024), default=512)
    ap.add_argument(
        "--prove", type=int, default=0, metavar="K",
        help="also Groth16-prove the first K signatures as a batch over "
        "the shared CRS (prove_batch) and verify every proof",
    )
    args = ap.parse_args()
    configure_compile_cache()
    params = get_params(args.n)
    rng = np.random.default_rng(0)

    t0 = time.time()
    insts = [make_instance(rng, params, msg=b"msg %d" % i)
             for i in range(args.k)]
    pk_bytes = [encode_public_key(i.h, params) for i in insts]
    sig_bytes = [
        compress_signature(i.sig_signed, i.nonce, params) for i in insts
    ]
    print(f"built {args.k} wire-format instances: {time.time()-t0:.1f}s")

    pipe = ProverInputPipeline(params, pack=True)
    t0 = time.time()
    out = pipe.run_wire(pk_bytes, [i.msg for i in insts], sig_bytes)
    import jax

    jax.block_until_ready(out.packed)
    dt = time.time() - t0
    print(f"decode + hash-to-point + witness + pack: {dt:.2f}s "
          f"({args.k/dt:,.1f} sigs/s incl. host stages)")

    # batched satisfiability verdict straight from the packed export
    compiled = compile_circuit(FalconNTTVerificationCircuit, insts[0])
    rs = ResidueSystem(compiled)
    ones = np.ones((args.k, 1), dtype=np.int64)
    instance_vals = np.concatenate(
        [ones, np.asarray(out.pk_ntt), np.asarray(out.hm_ntt)], axis=1
    )
    t0 = time.time()
    wres = rs.witness_residues_from_packed(instance_vals, out.packed)
    verdict = rs.check_device(wres)
    print(f"batched CRT satisfiability: all {args.k} valid = "
          f"{bool(verdict.all())} ({time.time()-t0:.2f}s)")
    assert verdict.all()

    if args.prove:
        # proof-side aggregation: K proofs over ONE
        # CRS via prove_batch — the multi-MSM amortizes the Montgomery
        # point conversion and the OpenMP task grid across the batch
        from falcon_r1cs_tpu.snark import prove_batch, setup, verify
        from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk
        from falcon_r1cs_tpu.snark.points import (
            ints_to_limbs,
            packed_to_limb_rows,
        )
        from falcon_r1cs_tpu.r1cs.coo import cache_dir

        kp = min(args.prove, args.k)
        crs = cache_dir() / f"FalconNTTVerificationCircuit_{args.n}.pk.npz"
        t0 = time.time()
        if crs.exists():
            pk = load_pk(crs)
            print(f"CRS loaded from cache: {time.time()-t0:.1f}s")
        else:
            pk = setup(compiled)
            save_pk(pk, crs)
            print(f"Groth16 setup (CRS cached): {time.time()-t0:.1f}s")
        packed = np.asarray(out.packed)
        publics = [
            [1] + [int(v) for v in row]
            for row in np.concatenate(
                [np.asarray(out.pk_ntt), np.asarray(out.hm_ntt)], axis=1
            )[:kp]
        ]
        assigns = [
            np.concatenate(
                [ints_to_limbs(publics[i], 4), packed_to_limb_rows(packed[i])]
            )
            for i in range(kp)
        ]
        t0 = time.time()
        proofs = prove_batch(pk, compiled, assigns)
        dt = time.time() - t0
        print(f"prove_batch K={kp}: {dt:.2f}s ({kp/dt:.2f} proofs/s)")
        t0 = time.time()
        assert all(
            verify(pk.vk, publics[i], proofs[i]) for i in range(kp)
        ), "a batched proof failed verification"
        print(f"all {kp} proofs verify ({time.time()-t0:.2f}s)")


if __name__ == "__main__":
    main()
