"""falcon_r1cs_tpu: R1CS constraint synthesis, batched device witness
generation and Groth16 proving for Falcon signature verification.

A brand-new JAX/XLA framework with the capabilities of the reference
Rust crate zhenfeizhang/falcon-r1cs (studied at /root/reference; see
SURVEY.md).  Public surface mirrors the reference's
(`/root/reference/falcon-r1cs/src/lib.rs:1-8`): the three circuits plus the
whole gadget layer, extended with the device subsystems the reference
lacks (batched witness engine, device-mesh sharding, sparse satisfiability
checking).
"""

from .circuits import (
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
)
from .gadgets import *  # noqa: F401,F403  (gadget layer is public surface)
from .gadgets import __all__ as _gadgets_all
from .params import FALCON_1024, FALCON_512, FIELD_MODULUS, Q, FalconParams, get_params
from .r1cs import Boolean, ConstraintSystem, FpVar, SynthesisError

# SNARK layer (ark-groth16 equivalent) is imported lazily by most users:
#   from falcon_r1cs_tpu.snark import setup, prove, verify

__version__ = "0.2.0"

__all__ = [
    "Boolean",
    "ConstraintSystem",
    "FALCON_1024",
    "FALCON_512",
    "FIELD_MODULUS",
    "FalconDualNTTVerificationCircuit",
    "FalconNTTVerificationCircuit",
    "FalconParams",
    "FalconSchoolBookVerificationCircuit",
    "FpVar",
    "Q",
    "SynthesisError",
    "get_params",
] + list(_gadgets_all)
