"""The bound-tracked NTT over exact 176-bit limb tensors: witness-side twin
of the ntt_circuit gadget.

Replicates, with real values, exactly the constraint-free butterfly
recursion of `/root/reference/falcon-r1cs/src/gadgets/poly.rs:104-159`:

    stage l:  v     = out[j+ht] * s          (s = table[m+i] < q)
              neg_v = 2^l * q^(l+2) - v      (const_vars[l+1], a multiple of
                                              q that dominates v)
              out[j], out[j+ht] = out[j] + v, out[j] + neg_v

then the final mod_q hint per output coefficient: quotient t = floor(V/q)
(the big ~2^146 witness) and remainder b = V mod q.  The (t, b) pairs ARE
the gadget's witness values -- butterflies allocate nothing.

Everything is batched: input (batch, n) int32 -> t limbs (L, batch, n) and
b (batch, n).  The stage loop is a static Python loop (log_n iterations)
unrolled into the jaxpr; butterflies within a stage are one vectorized
reshape + elementwise op over the whole (L, batch, n) tensor.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..params import FalconParams
from .limbs import (
    NUM_LIMBS,
    divmod_q,
    from_small,
    int_to_limbs,
    normalize,
)


def _semi_norm(x):
    """One parallel carry round: (x & 0xFFFF) + shift_up(x >> 16).

    Carries move one limb per round, so limbs stay in [-3, 2^16 + 2]: that
    keeps limb * s inside int32 for the next stage while preserving the
    redundant value exactly, and with one limb of headroom (192 bits over
    the 164-bit bound) the top limb never carries out.  Two whole-tensor
    passes replace the 11-step sequential carry chain."""
    low = jnp.bitwise_and(x, 0xFFFF)
    carry = jnp.right_shift(x, 16)  # arithmetic shift: signed-safe
    shifted = jnp.concatenate(
        [jnp.zeros_like(carry[:1]), carry[:-1]], axis=0
    )
    return low + shifted


_SEMI_LIMBS = NUM_LIMBS + 1  # 192-bit headroom: top limb never carries out


def ntt_with_hints(x, params: FalconParams, num_limbs: int = NUM_LIMBS):
    """Run the bound-tracked NTT on (batch, n) int32 coefficients in [0, q).

    Returns (t_limbs, b):
      t_limbs: (num_limbs, batch, n) int32 -- mod_q quotient hints
      b:       (batch, n) int32           -- NTT outputs in [0, q)

    Carries are semi-propagated per stage (one parallel round, exact in a
    redundant representation); the single full normalization + divmod runs
    once at the end.
    """
    n, log_n = params.n, params.log_n
    L = _SEMI_LIMBS
    table = np.asarray(params.ntt_table, dtype=np.int32)
    bounds = [
        jnp.asarray(int_to_limbs(c, L)) for c in params.const_q_powers
    ]

    batch = x.shape[0]
    out = from_small(x.astype(jnp.int32), L)  # (L, batch, n)

    for l in range(log_n):
        m = 1 << l
        half = n >> (l + 1)
        # view as (L, batch, m, 2, half): groups of two halves
        o = out.reshape(L, batch, m, 2, half)
        u = o[:, :, :, 0, :]                          # (L, batch, m, half)
        hi = o[:, :, :, 1, :]
        s = jnp.asarray(table[m : 2 * m]).reshape(1, 1, m, 1)
        v = _semi_norm(hi * s)                         # |limb*s| < 2^31
        c = bounds[l + 1].reshape(L, 1, 1, 1)
        new0 = _semi_norm(u + v)
        new1 = _semi_norm(u + (c - v))
        out = jnp.stack([new0, new1], axis=3).reshape(L, batch, n)

    t_limbs, b = divmod_q(normalize(out))
    return t_limbs[:num_limbs], b


def ntt_hints(x, params: FalconParams, backend: str = "xla"):
    """The hint NTT on the backend ops.backend.ntt_backend chose: the
    CUDA kernel ("cuda") or the XLA path above ("xla")."""
    if backend == "cuda":
        from .ntt_cuda import ntt_with_hints_cuda

        return ntt_with_hints_cuda(x, params)
    if backend != "xla":
        raise ValueError(f"unknown hint-NTT backend {backend!r}")
    return ntt_with_hints(x, params)


def intt_then_hints(w, params: FalconParams, backend: str = "xla"):
    """The v derivation chain: NTT-domain w = (hm - sig_ntt*pk) mod q ->
    (v_t limbs, v_b, v) where v = INTT(w) and (v_t, v_b) are its forward
    hint-NTT outputs."""
    from ..falcon.ntt import intt_jax

    v = intt_jax(w, params.n)
    t, b = ntt_hints(v, params, backend)
    return t, b, v
