"""Clear-side Falcon primitives (the JAX-native `falcon_core` layer).

Replaces the reference's falcon-rust dependency (SURVEY.md section 2.3):
polynomials/NTT over Z_q, hash-to-point, wire codecs, verification, and
trapdoor-free instance generation for tests and benchmarks.
"""

from .codec import (
    CodecError,
    compress_signature,
    decode_public_key,
    decompress_signature,
    encode_public_key,
)
from .hash_to_point import NONCE_LEN, hash_to_point, hash_to_point_batch
from .instances import (
    VerificationInstance,
    instance_from_signature,
    make_instance,
    make_instance_batch,
    verify,
    verify_batch,
)
from .keygen import NTRUSolveError, SecretKey, keygen, ntru_solve
from .sign import KeyPair, Signature, Signer
from .ntt import intt, negacyclic_mul, ntt, ntt_jax
from .poly import DualPolynomial, NTTPolynomial, Polynomial

__all__ = [
    "CodecError",
    "DualPolynomial",
    "NONCE_LEN",
    "NTTPolynomial",
    "Polynomial",
    "VerificationInstance",
    "compress_signature",
    "decode_public_key",
    "decompress_signature",
    "encode_public_key",
    "KeyPair",
    "NTRUSolveError",
    "SecretKey",
    "Signature",
    "Signer",
    "hash_to_point",
    "hash_to_point_batch",
    "instance_from_signature",
    "intt",
    "make_instance",
    "make_instance_batch",
    "keygen",
    "negacyclic_mul",
    "ntru_solve",
    "ntt",
    "ntt_jax",
    "verify",
    "verify_batch",
]
