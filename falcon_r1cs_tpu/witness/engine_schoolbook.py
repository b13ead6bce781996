"""Batched witness engine for the schoolbook verification circuit.

The heavy section is the n x n negacyclic product matrix: column i of the
reversed [-pk || pk] buffer against sig -- every one of the n^2 products is
itself a witness (the mul wires inside inner_product_mod), so the engine's
cost is dominated by materializing the (B, n, n) product tensor, which XLA
writes once while reducing its row sums.

Witness layout (allocation order of FalconSchoolBookVerificationCircuit):
  sig (n)
  v block (n, 28): per coeff [v_i | 14 bits | 13 chain]
  main loop (n, n+34): per column i:
      [t_i, c_i | n mul wires | 27 range chain of c_i |
       is_eq(rhs, v): [neq1, mult1] | is_eq(rhs, v+q): [neq2, mult2] |
       or wire]
  norm (2n, 18)  (v coeffs then sig coeffs)
  bound (50 | 52)

The is_eq multipliers take only three values on the valid path --
1 (equal branch), q^-1 mod p, and -(q^-1) mod p -- encoded on device as
codes {0, 1, 2} and expanded to field integers at interleave time.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..falcon.ntt import intt_jax, ntt_jax
from ..ops.modq import divmod_q as fast_divmod_q, mul_mod_q, sub_mod_q
from ..params import FIELD_MODULUS, FalconParams, Q, get_params
from .engine import _bits, _lt_q_chain, _norm_block, _bound_block_512, _bound_block_1024

Q_INV_MOD_P = pow(Q, FIELD_MODULUS - 2, FIELD_MODULUS)
NEG_Q_INV_MOD_P = FIELD_MODULUS - Q_INV_MOD_P


def generate_witness_schoolbook(sig, pk, hm, params: FalconParams):
    """All witness values for a batch.  Inputs (B, n) int32: sig lifted to
    [0, q); pk and hm in the COEFFICIENT domain (they are the circuit's
    public inputs here, unlike the NTT circuits)."""
    n = params.n
    sig = sig.astype(jnp.int32)
    pk = pk.astype(jnp.int32)
    hm = hm.astype(jnp.int32)

    # v = hm - sig*pk mod (q, x^n+1)
    v = intt_jax(
        sub_mod_q(ntt_jax(hm, n), mul_mod_q(ntt_jax(sig, n), ntt_jax(pk, n))),
        n,
    )

    v_bits = _bits(v, 14)
    v_block = jnp.concatenate(
        [v[..., None], v_bits, _lt_q_chain(v_bits, v)], axis=-1
    )  # (B, n, 28)

    # buffer = reversed([q - pk || pk]); column i = buf[n-1-i:2n-1-i]
    buf = jnp.flip(jnp.concatenate([Q - pk, pk], axis=-1), axis=-1)  # (B, 2n)
    # cols[b, i, j] = buf[b, n-1-i+j]: one gather into (B, n, n)
    idx = (n - 1) - jnp.arange(n)[:, None] + jnp.arange(n)[None, :]
    cols = buf[:, idx]                       # (B, n, n): cols[b, i, j]
    prods = sig[:, None, :] * cols           # (B, n, n) mul wires

    # exact 38-bit sums via 16-bit split accumulation
    lo = jnp.sum(jnp.bitwise_and(prods, 0xFFFF), axis=-1)  # < n*2^16
    hi = jnp.sum(prods >> 16, axis=-1)                     # < n*2^12
    H = hi + (lo >> 16)
    L = jnp.bitwise_and(lo, 0xFFFF)
    tq, r = fast_divmod_q(H)
    tl, c = fast_divmod_q((r << 16) + L)
    t = (tq << 16) + tl                                      # quotient hint

    c_bits = _bits(c, 14)
    c_chain = _lt_q_chain(c_bits, c)

    # rhs = hm + q - c; valid path: rhs == v or rhs == v + q
    rhs = hm + Q - c
    d1 = rhs - v
    d2 = rhs - v - Q
    neq1 = (d1 != 0).astype(jnp.int32)
    neq2 = (d2 != 0).astype(jnp.int32)
    # multiplier codes: 0 -> 1 (equal), 1 -> q^-1, 2 -> -q^-1; the engine
    # covers the valid-path diffs {0, +-q} (anything else would make the
    # constraint system unsatisfiable anyway)
    def mult_code(d):
        return jnp.where(d == 0, 0, jnp.where(d == Q, 1, 2))

    m1 = mult_code(d1)
    m2 = mult_code(d2)
    or_wire = neq1 * neq2

    # validity flag: for in-range inputs (sig, hm in [0, q), pk in [0, q))
    # the diffs are provably in {0, +q} / {0, -q}; anything else means the
    # caller fed out-of-range data and the code-expanded multipliers would
    # silently diverge from the host trace.  (B,) int32, 1 = trustworthy.
    ok = ((d1 == 0) | (d1 == Q)) & ((d2 == 0) | (d2 == -Q))
    valid = jnp.all(ok, axis=-1).astype(jnp.int32)

    # the main-loop block is kept as separate tensors: concatenating the
    # (B, n, n) product tensor into one (B, n, n+34) array costs a full
    # extra copy of the dominant buffer
    tc = jnp.stack([t, c], axis=-1)                       # (B, n, 2)
    c_tail = jnp.concatenate([c_bits, c_chain], axis=-1)  # (B, n, 27)
    iseq = jnp.stack([neq1, m1, neq2, m2, or_wire], axis=-1)  # (B, n, 5)

    # norm over v || sig
    coeffs = jnp.concatenate([v, sig], axis=-1)
    nbits16, sel, sq = _norm_block(coeffs)
    norm_blk = jnp.concatenate(
        [nbits16, sel[..., None], sq[..., None]], axis=-1
    )  # mixed concat promotes to int32: canonical 18-wide block
    sum_lo = jnp.sum(jnp.bitwise_and(sq, 0xFFFF), axis=-1)
    sum_hi = jnp.sum(sq >> 16, axis=-1)
    norm_lo = jnp.bitwise_and(sum_lo, 0xFFFF)
    norm_hi = sum_hi + (sum_lo >> 16)
    bound = (
        _bound_block_512(norm_lo, norm_hi)
        if n == 512
        else _bound_block_1024(norm_lo, norm_hi)
    )

    return {
        "sig": sig, "v_block": v_block,
        "tc": tc, "prods": prods, "c_tail": c_tail, "iseq": iseq,
        "norm": norm_blk, "bound": bound, "pk": pk, "hm": hm,
        "valid": valid,
    }


@functools.lru_cache(maxsize=None)
def jitted_engine_schoolbook(n: int):
    """jit-compiled schoolbook witness generator.  It has no hint NTT, so
    every platform runs the same XLA program."""
    params = get_params(n)
    return jax.jit(
        lambda sig, pk, hm: generate_witness_schoolbook(sig, pk, hm, params)
    )


_MULT_VALUES = np.asarray([1, Q_INV_MOD_P, NEG_Q_INV_MOD_P], dtype=object)


def interleave_witness_schoolbook(seg: dict, params: FalconParams) -> np.ndarray:
    n = params.n
    o = lambda k: np.asarray(seg[k], dtype=object)
    B = o("sig").shape[0]
    # reassemble the per-column block [t, c | prods | c range chain |
    # neq1, mult1, neq2, mult2, or] with multiplier codes expanded
    iseq = o("iseq")
    for slot in (1, 3):  # mult1, mult2
        iseq[:, :, slot] = _MULT_VALUES[
            np.asarray(seg["iseq"])[:, :, slot].astype(np.int64)
        ]
    main = np.concatenate(
        [o("tc"), o("prods"), o("c_tail"), iseq], axis=-1
    )
    parts = [
        o("sig"),
        o("v_block").reshape(B, -1),
        main.reshape(B, -1),
        o("norm").reshape(B, -1),
        o("bound"),
    ]
    return np.concatenate(parts, axis=1)
