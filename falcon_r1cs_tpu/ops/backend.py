"""Which implementation runs the hint NTT, decided by the platform.

Every witness engine's hot path is the bound-tracked limb NTT.  It has
two implementations:

  "cuda"  the CUDA kernel (ops/ntt_cuda.py): one thread block per
          signature, limbs in shared memory across all stages;
  "xla"   the plain JAX formulation (ops/ntt_limb.py) that every
          platform compiles.

The choice looks at `jax.default_backend()` alone: an NVIDIA GPU ("gpu")
runs the kernel, every other platform the XLA path.  The preference
`RuntimeConfig.use_ntt_kernel` can force the XLA path (False) or insist
on the kernel (True); insisting on a platform that has none raises.  On
the GPU a kernel that fails to build or compile raises as well: nothing
falls back quietly.
"""

from __future__ import annotations

# platform (as jax.default_backend() names it) -> its hint-NTT kernel
KERNELS = {"gpu": "cuda"}


def ntt_backend(pref: bool | None, platform: str) -> str:
    """"cuda" or "xla" for a preference (None = the platform's choice)
    on `platform`."""
    if pref is False:
        return "xla"
    kernel = KERNELS.get(platform)
    if kernel is None:
        if pref:
            raise RuntimeError(
                f"use_ntt_kernel=True, but platform {platform!r} has no "
                "hint-NTT kernel"
            )
        return "xla"
    return kernel


def configured_ntt_backend() -> str:
    """ntt_backend for the runtime config's preference on the default
    platform."""
    import jax

    from ..utils.config import get_config

    return ntt_backend(get_config().use_ntt_kernel, jax.default_backend())
