"""The CUDA hint-NTT kernel (ops/ntt_hints.cu) as a JAX operation.

`ntt_with_hints_cuda` is a drop-in for ops.ntt_limb.ntt_with_hints on an
NVIDIA GPU: the same (t limbs, b) outputs, bit for bit, from one kernel
launch with one thread block per signature.  The shared library is built
by nvcc for sm_90a (Hopper) on first use, keyed like every native build
(native/build.py), and registered as an XLA FFI target.  A failed build
raises: on the GPU there is no silent fallback to the XLA path.

The kernel has no interpreter.  What surrounds it is plain Python that
the CPU tests reach: the stage tables, the active-limb schedule and the
output shapes (tests/test_ntt_cuda.py, which also replays the kernel's
limb sweep in numpy against the XLA path).
"""

from __future__ import annotations

import functools
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..params import FalconParams
from .limbs import LIMB_BITS, NUM_LIMBS, int_to_limbs

TARGET = "falcon_ntt_hints"
_SRC = Path(__file__).resolve().parent / "ntt_hints.cu"


def stage_tables(params: FalconParams):
    """(table (n,), bounds (log_n + 1, NUM_LIMBS), active (log_n,)) int32.

    bounds[l] are the limbs of const_q_powers[l]: stage l adds
    bounds[l + 1] - v on the hi side.  active[l] is the number of limb
    rows stage l touches: its outputs stay below 2 * const_q_powers[l+1],
    so rows above ceil((bits + 2) / 16) are zero throughout."""
    table = np.asarray(params.ntt_table, dtype=np.int32)
    bounds = np.stack(
        [int_to_limbs(c, NUM_LIMBS) for c in params.const_q_powers]
    ).astype(np.int32)
    active = np.asarray(
        [
            min(NUM_LIMBS,
                (c.bit_length() + 2 + LIMB_BITS - 1) // LIMB_BITS)
            for c in params.const_q_powers[1:]
        ],
        dtype=np.int32,
    )
    return table, bounds, active


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build_command() -> list[str]:
    """The nvcc invocation (without its output) that builds the kernel."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), str(_SRC),
    ]


def _ffi_headers() -> list[Path]:
    api = Path(jax.ffi.include_dir()) / "xla" / "ffi" / "api"
    return sorted(api.glob("*.h"))


@functools.lru_cache(maxsize=None)
def register() -> Path:
    """Build the kernel library if needed and register its FFI target
    (once per process).  Raises on any failure."""
    import ctypes

    from ..native.build import build_library

    so = build_library(
        "ntt_hints_cuda", [_SRC, *_ffi_headers()], [build_command()]
    )
    lib = ctypes.cdll.LoadLibrary(str(so))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.FalconNttHints), platform="CUDA"
    )
    return so


def ntt_with_hints_cuda(x, params: FalconParams):
    """(batch, n) coefficients in [0, q) -> (t (NUM_LIMBS, batch, n),
    b (batch, n)) int32, bit-equal to ops.ntt_limb.ntt_with_hints."""
    register()
    x = jnp.asarray(x).astype(jnp.int32)
    batch, n = x.shape
    if n != params.n:
        raise ValueError(f"x has {n} coefficients, params.n = {params.n}")
    table, bounds, active = stage_tables(params)
    return jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((NUM_LIMBS, batch, n), jnp.int32),
            jax.ShapeDtypeStruct((batch, n), jnp.int32),
        ),
    )(x, table, bounds, active)
