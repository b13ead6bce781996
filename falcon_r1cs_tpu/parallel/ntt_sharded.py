"""Coefficient-sharded NTT via shard_map + ppermute: the sequence-parallel
analog (SURVEY.md section 2.4 "NTT-stage parallelism").

With the coefficient axis sharded over D devices (shard width w = n/D),
Cooley-Tukey stage l pairs positions j and j + n/2^(l+1):

  * the first log2(D) stages pair across shards -- each shard exchanges its
    whole block with its butterfly partner (shard_id XOR D >> (l+1)) via
    lax.ppermute (NCCL over NVLink between GPUs), then computes its half
    of the butterflies locally (within those stages a shard lies inside
    ONE twiddle group, so
    the stage twiddle is a per-shard scalar);
  * the remaining log2(n) - log2(D) stages are purely local.

This is the direct analog of ring/Ulysses head-vs-sequence re-sharding:
shard width is chosen so only log2(D) stages need communication
(SURVEY.md section 7 hard part 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q
from ..params import FalconParams


def ntt_sharded(mesh: Mesh, params: FalconParams, axis: str = "coeff"):
    """Returns a jitted (B, n)->(B, n) forward NTT with the coefficient
    axis sharded over `axis` of `mesh`.  Inputs in [0, q)."""
    n, log_n = params.n, params.log_n
    D = mesh.shape[axis]
    if D & (D - 1) or n % D:
        raise ValueError(f"device axis {D} must be a power of two dividing n")
    log_d = D.bit_length() - 1
    w = n // D
    table = np.asarray(params.ntt_table, dtype=np.int32)

    def local_fn(x):  # x: (B, w) local shard
        r = jax.lax.axis_index(axis)

        # --- cross-shard stages: l = 0 .. log_d-1 -----------------------
        for l in range(log_d):
            m = 1 << l
            dist = D >> (l + 1)           # partner distance in shards
            partner_perm = [
                (src, src ^ dist) for src in range(D)
            ]
            other = jax.lax.ppermute(x, axis, partner_perm)
            is_lo = (r & dist) == 0
            # per-shard scalar twiddle: group index = r >> (log_d - l)
            group = r >> (log_d - l)
            s = jnp.asarray(table)[m + group]
            # lo shard: u = x, v = other*s;    out = u + v
            # hi shard: u = other, v = x*s;    out = u + (q - ...) i.e. u - v
            v_lo = mul_mod_q(other, s)
            v_hi = mul_mod_q(x, s)
            x = jnp.where(
                is_lo, add_mod_q(x, v_lo), sub_mod_q(other, v_hi)
            )

        # --- local stages: l = log_d .. log_n-1 -------------------------
        B = x.shape[0]
        for l in range(log_d, log_n):
            m = 1 << l
            half = n >> (l + 1)
            # groups fully inside the shard: local group count = m // D
            mloc = m // D
            x = x.reshape(B, mloc, 2, half)
            # global group index of local group i: r*mloc + i
            base = m + r * mloc
            s = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(table), base, mloc
            ).reshape(1, mloc, 1)
            u = x[:, :, 0, :]
            v = mul_mod_q(x[:, :, 1, :], s)
            x = jnp.stack([add_mod_q(u, v), sub_mod_q(u, v)], axis=2)
        return x.reshape(B, w)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(None, axis),
        out_specs=P(None, axis),
    )
    return jax.jit(fn)


def ntt_with_hints_local(x, axis: str, params: FalconParams, D: int):
    """Shard-local bound-tracked NTT with quotient hints (call INSIDE
    shard_map, coefficient axis sharded over `axis`; D = static shard
    count of that axis, from mesh.shape).

    The sequence-parallel twin of ops/ntt_limb.ntt_with_hints: the first
    log2(D) butterfly stages exchange whole limb blocks with the partner
    shard via lax.ppermute (per-shard scalar twiddles), the remaining
    stages are local with the same vectorized reshape butterflies; limb
    arithmetic (semi-normalized carries, neg_v bound constants, final
    normalize + divmod) is identical, so the (t, b) witness outputs are
    bit-equal to the single-device engine.

    x: (B, w) int32 local coefficient block, w = n / D.
    Returns (t_limbs (L, B, w), b (B, w)) local blocks.
    """
    from ..ops.limbs import (
        NUM_LIMBS,
        divmod_q as limb_divmod_q,
        from_small,
        int_to_limbs,
        normalize,
    )
    from ..ops.ntt_limb import _SEMI_LIMBS, _semi_norm

    n, log_n = params.n, params.log_n
    if n % D:
        raise ValueError(f"coeff axis size {D} must divide n={n}")
    log_d = D.bit_length() - 1
    if 1 << log_d != D:
        raise ValueError(f"coeff axis size {D} must be a power of two")
    w = n // D
    L = _SEMI_LIMBS
    table = np.asarray(params.ntt_table, dtype=np.int32)
    bounds = [
        jnp.asarray(int_to_limbs(c, L)) for c in params.const_q_powers
    ]

    r = jax.lax.axis_index(axis)
    B = x.shape[0]
    out = from_small(x.astype(jnp.int32), L)  # (L, B, w)

    # cross-shard stages: the shard lies inside one butterfly group, so
    # the twiddle is a per-shard scalar and the exchange is one ppermute
    for l in range(log_d):
        m = 1 << l
        dist = D >> (l + 1)
        other = jax.lax.ppermute(
            out, axis, [(src, src ^ dist) for src in range(D)]
        )
        is_lo = (r & dist) == 0
        group = r >> (log_d - l)
        s = jnp.asarray(table)[m + group]
        c = bounds[l + 1].reshape(L, 1, 1)
        v_lo = _semi_norm(other * s)         # partner holds the hi half
        v_hi = _semi_norm(out * s)           # we ARE the hi half
        out = jnp.where(
            is_lo,
            _semi_norm(out + v_lo),          # u + v
            _semi_norm(other + (c - v_hi)),  # u + neg_v
        )

    # local stages: identical to ops/ntt_limb with shard-offset twiddles
    for l in range(log_d, log_n):
        m = 1 << l
        half = n >> (l + 1)
        mloc = m // D
        o = out.reshape(L, B, mloc, 2, half)
        u = o[:, :, :, 0, :]
        hi = o[:, :, :, 1, :]
        base = m + r * mloc
        s = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(table), base, mloc
        ).reshape(1, 1, mloc, 1)
        v = _semi_norm(hi * s)
        c = bounds[l + 1].reshape(L, 1, 1, 1)
        new0 = _semi_norm(u + v)
        new1 = _semi_norm(u + (c - v))
        out = jnp.stack([new0, new1], axis=3).reshape(L, B, w)

    t_limbs, b = limb_divmod_q(normalize(out))
    return t_limbs[:NUM_LIMBS], b
