"""Proof-of-knowledge-of-signature: the full analog of the reference's
`examples/pok_sig.rs` (`/root/reference/falcon-r1cs/examples/pok_sig.rs`).

Reference flow (pok_sig.rs:15-47):
  keygen -> sign -> build circuit -> Groth16 setup -> prove -> verify.

This example runs the same end-to-end pipeline with our components, plus
the device stages the reference doesn't have:

  real NTRU keygen + signing -> circuit synthesis (cached COO) ->
  batched device witness generation -> device CRT satisfiability check ->
  Groth16 setup (CRS cached to disk) -> prove -> pairing verify.

Usage: python examples/pok_sig.py [512|1024]   (default 512; the
reference example is hard-wired to 512, pok_sig.rs:15).
"""

import time
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from falcon_r1cs_tpu import FalconNTTVerificationCircuit
from falcon_r1cs_tpu.falcon import ntt
from falcon_r1cs_tpu.params import get_params
from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem
from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
from falcon_r1cs_tpu.snark import prove, setup, verify
from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache
from falcon_r1cs_tpu.witness import interleave_witness, jitted_engine


def main():
    configure_compile_cache()
    rng = np.random.default_rng(0)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    params = get_params(n)
    print(f"parameter set: Falcon-{n}")

    # real keygen + deterministic signing (the reference's pok_sig flow:
    # `pok_sig.rs:15-21`), then clear verification
    from falcon_r1cs_tpu.falcon import KeyPair, instance_from_signature

    t0 = time.time()
    keypair = KeyPair.generate(rng, params)
    msg = b"testing message"
    sig = keypair.signer.sign_with_seed(b"test seed", msg)
    assert keypair.verify(msg, sig)
    print(f"keygen+sign+verify: {time.time()-t0:.2f}s "
          f"(|s2|max={abs(sig.s2).max()})")
    inst = instance_from_signature(keypair.h, msg, sig.nonce, sig.s2, params)

    # circuit-specific synthesis: shape-only trace -> compiled COO (cached)
    t0 = time.time()
    compiled = compile_circuit(FalconNTTVerificationCircuit, inst)
    print(f"synthesis (trace+compile, cached): {time.time()-t0:.2f}s; "
          f"{compiled.num_constraints} constraints, nnz={compiled.nnz()}")

    # batched witness generation on device
    t0 = time.time()
    sig_arr = inst.sig_lifted[None].astype(np.int32)
    pk_ntt = ntt(inst.h)[None].astype(np.int32)
    hm_ntt = ntt(inst.hm)[None].astype(np.int32)
    run = jitted_engine(params.n)
    seg = {k: np.asarray(v) for k, v in run(sig_arr, pk_ntt, hm_ntt).items()}
    wit = interleave_witness(seg, params)
    print(f"witness (device engine): {time.time()-t0:.2f}s")

    # public inputs in the contract order: one || pk_ntt || hm_ntt
    public_inputs = [1] + [int(v) for v in seg["pk_ntt"][0]] + [
        int(v) for v in seg["hm_ntt"][0]
    ]
    assignment = public_inputs + [int(v) for v in wit[0]]

    # fast sanity: the R1CS satisfiability check on device
    rs = ResidueSystem(compiled)
    arr = np.asarray(assignment, dtype=object)[None]
    ok = rs.is_satisfied(arr)
    print(f"R1CS satisfied (device CRT check): {bool(ok[0])}")
    assert ok[0]

    # Groth16 setup (pok_sig.rs:30-32) — CRS cached beside the R1CS
    crs_path = cache_dir() / f"{FalconNTTVerificationCircuit.__name__}_{params.n}.pk.npz"
    t0 = time.time()
    if crs_path.exists():
        pk = load_pk(crs_path)
        print(f"CRS load (cached): {time.time()-t0:.2f}s")
    else:
        pk = setup(compiled)
        save_pk(pk, crs_path)
        print(f"Groth16 setup: {time.time()-t0:.2f}s")

    # prove (pok_sig.rs:36-37) — production form: witness limbs straight
    # from the device packer (no Python bigint round trip)
    from falcon_r1cs_tpu.snark.points import ints_to_limbs, packed_to_limb_rows
    from falcon_r1cs_tpu.witness.export_device import packer_ntt

    t0 = time.time()
    packed = np.asarray(packer_ntt(params.n)(seg))
    assignment_limbs = np.concatenate(
        [ints_to_limbs(public_inputs, 4), packed_to_limb_rows(packed[0])]
    )
    proof = prove(pk, compiled, assignment_limbs)
    print(f"Groth16 prove (device-packed witness): {time.time()-t0:.2f}s")

    # verify (pok_sig.rs:39-47)
    t0 = time.time()
    assert verify(pk.vk, public_inputs, proof)
    print(f"Groth16 verify: OK {time.time()-t0:.2f}s")

    bad = list(public_inputs)
    bad[1] = (bad[1] + 1) % params.q
    assert not verify(pk.vk, bad, proof)
    print("tampered public input rejected")


if __name__ == "__main__":
    main()
