"""Clear-side (non-circuit) NTT over Z_q, numpy and batched-JAX flavors.

JAX-native equivalent of the falcon-rust polynomial layer's clear NTT
(`NTTPolynomial::from(&Polynomial)`, used at
`/root/reference/falcon-r1cs/src/circuits/falcon_ntt.rs:45,51`).  The loop
structure mirrors the Falcon C `mq_NTT` / the reference circuit loop
(`/root/reference/falcon-r1cs/src/gadgets/poly.rs:116-149`) but is expressed
stage-wise over whole coefficient tensors so it vectorizes on the device and
vmaps over a batch axis.
"""

from __future__ import annotations

import numpy as np

from ..params import Q, get_params


def ntt(coeffs: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT of int array(s) with trailing axis n. mod q.

    Accepts shape (..., n).  Stage-wise Cooley-Tukey: at stage l the array is
    viewed as (..., 2^l, 2, half) and each pair of halves is combined with the
    per-group twiddle table[2^l + i] -- the same access pattern as
    `/root/reference/falcon-r1cs/src/gadgets/poly.rs:122`.
    """
    x = np.asarray(coeffs, dtype=np.int64) % Q
    n = x.shape[-1]
    p = get_params(n)
    table = np.asarray(p.ntt_table, dtype=np.int64)
    batch = x.shape[:-1]
    for l in range(p.log_n):
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(*(1,) * len(batch), m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :] * s % Q
        x = np.stack([(u + v) % Q, (u - v) % Q], axis=-2)
    return x.reshape(*batch, n).astype(np.int64)


def intt(coeffs: np.ndarray) -> np.ndarray:
    """Inverse negacyclic NTT (Gentleman-Sande), mod q. Shape (..., n).

    Clear-side only: the reference circuits contain no inverse NTT (the dead
    `inv_ntt_param_var` at `/root/reference/falcon-r1cs/src/gadgets/misc.rs:80`
    notwithstanding).  Needed by our instance generator and verifier.
    """
    x = np.asarray(coeffs, dtype=np.int64) % Q
    n = x.shape[-1]
    p = get_params(n)
    table = np.asarray(p.inv_ntt_table, dtype=np.int64)
    batch = x.shape[:-1]
    for l in range(p.log_n - 1, -1, -1):
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(*(1,) * len(batch), m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = np.stack([(u + v) % Q, (u - v) * s % Q], axis=-2)
    x = x.reshape(*batch, n)
    n_inv = pow(n, Q - 2, Q)
    return x * n_inv % Q


def ntt_jax(coeffs, n: int):
    """Batched forward NTT in JAX (int32 lanes), jit/vmap-friendly.

    Shape (..., n) -> (..., n); inputs must already be in [0, q).  All
    intermediates are reduced per stage with division-free mod-q ops
    (ops/modq.py) so everything fits in int32.
    """
    import jax.numpy as jnp

    from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q

    p = get_params(n)
    table = jnp.asarray(p.ntt_table, dtype=jnp.int32)
    x = coeffs.astype(jnp.int32)
    batch = x.shape[:-1]
    sh = (1,) * len(batch)
    # radix-4 passes: two butterfly levels per materialized tensor.  XLA
    # keeps each stage's reshape/stack as a full HBM round trip, so
    # fusing level pairs halves the log_n traffic (~2x fewer passes);
    # the mod-q op composition is IDENTICAL to two radix-2 levels, so
    # outputs are bit-equal.
    l = 0
    while l + 1 < p.log_n:
        m1 = 1 << l
        m2 = m1 << 1
        half2 = n >> (l + 2)
        x = x.reshape(*batch, m1, 4, half2)
        s1 = table[m1 : 2 * m1].reshape(*sh, m1, 1)
        s2 = table[m2 : 2 * m2].reshape(*sh, m1, 2, 1)
        s2a = s2[..., 0, :]
        s2b = s2[..., 1, :]
        b0, b1 = x[..., 0, :], x[..., 1, :]
        b2, b3 = x[..., 2, :], x[..., 3, :]
        t2 = mul_mod_q(b2, s1)
        t3 = mul_mod_q(b3, s1)
        a0, a2 = add_mod_q(b0, t2), sub_mod_q(b0, t2)
        a1, a3 = add_mod_q(b1, t3), sub_mod_q(b1, t3)
        u1 = mul_mod_q(a1, s2a)
        u3 = mul_mod_q(a3, s2b)
        x = jnp.stack(
            [add_mod_q(a0, u1), sub_mod_q(a0, u1),
             add_mod_q(a2, u3), sub_mod_q(a2, u3)],
            axis=-2,
        )
        l += 2
    if l < p.log_n:
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(*sh, m, 1)
        u = x[..., 0, :]
        v = mul_mod_q(x[..., 1, :], s)
        x = jnp.stack([add_mod_q(u, v), sub_mod_q(u, v)], axis=-2)
    return x.reshape(*batch, n)


def intt_jax(coeffs, n: int):
    """Batched inverse NTT in JAX (int32 lanes), jit/vmap-friendly.
    Inputs must already be in [0, q)."""
    import jax.numpy as jnp

    from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q

    p = get_params(n)
    table = jnp.asarray(p.inv_ntt_table, dtype=jnp.int32)
    x = coeffs.astype(jnp.int32)
    batch = x.shape[:-1]
    sh = (1,) * len(batch)
    # radix-4 passes (levels l, l-1 fused; see ntt_jax): halves the
    # materialized HBM round trips, bit-equal op composition
    l = p.log_n - 1
    while l >= 1:
        m1 = 1 << l
        m2 = m1 >> 1
        half1 = n >> (l + 1)
        x = x.reshape(*batch, m2, 4, half1)
        s1 = table[m1 : 2 * m1].reshape(*sh, m2, 2, 1)
        s1a = s1[..., 0, :]
        s1b = s1[..., 1, :]
        s2 = table[m2 : 2 * m2].reshape(*sh, m2, 1)
        b0, b1 = x[..., 0, :], x[..., 1, :]
        b2, b3 = x[..., 2, :], x[..., 3, :]
        a0 = add_mod_q(b0, b1)
        a1 = mul_mod_q(sub_mod_q(b0, b1), s1a)
        a2 = add_mod_q(b2, b3)
        a3 = mul_mod_q(sub_mod_q(b2, b3), s1b)
        x = jnp.stack(
            [add_mod_q(a0, a2), add_mod_q(a1, a3),
             mul_mod_q(sub_mod_q(a0, a2), s2),
             mul_mod_q(sub_mod_q(a1, a3), s2)],
            axis=-2,
        )
        l -= 2
    if l == 0:
        half = n >> 1
        x = x.reshape(*batch, 1, 2, half)
        s = table[1:2].reshape(*sh, 1, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = jnp.stack(
            [add_mod_q(u, v), mul_mod_q(sub_mod_q(u, v), s)], axis=-2
        )
    x = x.reshape(*batch, n)
    n_inv = pow(n, Q - 2, Q)
    return mul_mod_q(x, jnp.int32(n_inv))


def negacyclic_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c = a * b mod (x^n + 1, q) via NTT. Shapes broadcast over (..., n)."""
    n = a.shape[-1]
    return intt(ntt(a) * ntt(b) % Q)
