"""G1-MSM backend policy for the Groth16 prover.

`groth16.prove(g1_backend="auto")` resolves here, as a pure function of
whether the native library is available, so the decision is testable
without a device:

  native   native/groth16_native.c, whenever it builds and passes its
           selftest;
  python   the pure-Python group law otherwise.

The device MSM (snark/tpu_msm.py, plain JAX) runs only when asked for by
name ("tpu"): no GPU measurement shows it ahead of the host library yet,
and a device MSM designed for the GPU is its own piece of work
(ROADMAP B3).

Env override (wins outright): FALCON_R1CS_TPU_G1_BACKEND =
native | tpu | python.

Reference anchor: examples/pok_sig.rs:30-31 — the reference's prover
backend is decided at link time by cargo features; here it is a
runtime decision.
"""

from __future__ import annotations

import os

_VALID = ("native", "tpu", "python")


def choose_g1_backend(native_available: bool) -> str:
    """Resolve "auto" to a concrete G1-MSM backend."""
    env = os.environ.get("FALCON_R1CS_TPU_G1_BACKEND")
    if env:
        if env not in _VALID:
            raise ValueError(
                f"FALCON_R1CS_TPU_G1_BACKEND={env!r}: want one of {_VALID}"
            )
        return env
    return "native" if native_available else "python"
