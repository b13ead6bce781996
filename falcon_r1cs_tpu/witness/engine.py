"""Batched device witness engine for the verify-with-NTT circuit.

The execute-phase twin of the trace layer (SURVEY.md section 7 step 2): one
jitted function computes EVERY witness value of
`FalconNTTVerificationCircuit` for a whole batch of signatures as dense
tensors, bit-exactly equal to the host trace's `cs.witness_values` (the
parity contract).  Hot paths: the limbed bound-tracked NTT
(ops/ntt_limb.py) and vectorized hint/bit/boolean-chain computation.

Witness layout (allocation order of the circuit, per signature; n = N):
  sig            (n,)        input coefficients [0, q)
  v              (n,)        v = hm - sig*pk lifted to [0, q)
  range_v        (n, 27)     per coeff: 14 bits | w1..w11 | w12 | w13
  sig_ntt mod_q  (n, 29)     per coeff: t | b | 14 bits | 13 chain
  v_ntt mod_q    (n, 29)     (t is the ~2^146 big quotient, limb-encoded)
  pointwise      (n, 30)     per coeff: prod | t | c | 14 bits | 13 chain
  norm           (2n, 18)    per coeff (v then sig): 14 bits | nor | and |
                             select | square
  bound          (50 | 52,)  26/27 bits | kary chain | binary chain

Segment tensors split value/bit parts to shrink HBM writes ~2.5x: pure
bit/boolean tensors (range_v, *_tail, norm_bits, bound) are int8, values
int32; `pointwise` is stored as [prod|t|c] (n,3) + tail (n,27) and `norm`
as bits (2n,16) + [select|square] (2n,2); layout.py re-interleaves the
canonical order above.

Boolean-chain value semantics (see r1cs/wires.py): `or` allocates the NOR
(1-a)(1-b); `and` allocates the product; kary folds left.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
from ..falcon.ntt import ntt_jax
from ..ops.modq import divmod_q as fast_divmod_q, mul_mod_q, sub_mod_q
from ..ops.ntt_limb import ntt_with_hints
from ..params import FalconParams, Q, get_params

RANGE_W = 27
MODQ_W = 29
PW_W = 30
NORM_W = 18


def _bits(x, count):
    """(...,) int32 -> (..., count) bits, little-endian.

    int8 output: bit and boolean-chain witnesses are the bulk of the
    engine's HBM writes, and at 1 byte instead of 4 the write-bound tail
    of the engine shrinks ~3x."""
    shifts = jnp.arange(count, dtype=jnp.int32)
    return jnp.bitwise_and(x[..., None] >> shifts, 1).astype(jnp.int8)


def _lt_q_chain(bits14, val=None):
    """The 13 logic witnesses of enforce_less_than_q after the 14 bits:
    w_k = prod_{i<=k}(1-b_i) for k=1..11; w12 = b12*(1-w11);
    w13 = b13*w12.

    When the source VALUE (int32 in [0, 2^14)) is given, the prefix
    products collapse to masked zero-tests — w_k = prod_{i<=k}(1-b_i) is
    just [val mod 2^(k+1) == 0] — one fused elementwise op instead of a
    cumprod, whose log-step pad/multiply lowering costs several passes
    at each of the four chain call sites."""
    if val is not None:
        masks = jnp.asarray(
            [(1 << (k + 1)) - 1 for k in range(1, 12)], jnp.int32
        )
        w = (jnp.bitwise_and(val[..., None], masks) == 0).astype(jnp.int8)
        w11 = w[..., -1]
        w12 = bits14[..., 12] * (1 - w11)
        w13 = bits14[..., 13] * w12
        return jnp.concatenate(
            [w, w12[..., None], w13[..., None]], axis=-1
        )
    nb = 1 - bits14
    pref = jnp.cumprod(nb[..., :12], axis=-1)  # pref[k] = prod_{i<=k}(1-b_i)
    w = pref[..., 1:12]                        # w1..w11
    w12 = bits14[..., 12] * (1 - pref[..., 11])
    w13 = bits14[..., 13] * w12
    return jnp.concatenate(
        [w, w12[..., None], w13[..., None]], axis=-1
    )


def _modq_block(t_val, b_val):
    """[t, b, bits, chain] given quotient t (any int32 array slot; for the
    NTT blocks t is passed separately as limbs) and remainder b < q."""
    bits = _bits(b_val, 14)
    chain = _lt_q_chain(bits, b_val)
    return bits, chain


def _norm_block(c):
    """is_less_than_6144 + select + square for coeffs c in [0, q):
    returns (bits16 int8, sel, sq) where bits16 = 14 bits | nor=b12*b11 |
    and=(1-b13)(1-nor); the canonical 18-wide block is
    [bits16 | select | square]."""
    bits = _bits(c, 14)
    w_nor = bits[..., 12] * bits[..., 11]
    w_and = ((1 - bits[..., 13]) * (1 - w_nor)).astype(jnp.int8)
    sel = jnp.where(w_and == 1, c, Q - c)
    sq = sel * sel
    bits16 = jnp.concatenate(
        [bits, w_nor[..., None], w_and[..., None]], axis=-1
    )
    return bits16, sel, sq


def _norm_block_t(c):
    """_norm_block with the FEATURE axis OUTERMOST: bits16 (16, B, 2n).

    The feature-minor stack (B, 2n, 16) forces XLA into a layout copy
    of the whole segment: a concatenate fusion wants the concat axis
    outermost ({2,0,1}), the row-major output does not.  Putting the
    feature axis first makes them agree — the same trick the (L, B, n)
    NTT hint tensors already use.  Consumers (witness/layout.py, the
    export_device index tables) read the transposed order."""
    shifts = jnp.arange(14, dtype=jnp.int32)[:, None, None]
    bits = jnp.bitwise_and(c[None, :, :] >> shifts, 1).astype(jnp.int8)
    w_nor = bits[12] * bits[11]
    w_and = ((1 - bits[13]) * (1 - w_nor)).astype(jnp.int8)
    sel = jnp.where(w_and == 1, c, Q - c)
    sq = sel * sel
    bits16 = jnp.concatenate(
        [bits, w_nor[None], w_and[None]], axis=0
    )
    return bits16, sel, sq


def _nor_prefix(bits):
    """kary_or witness values: prefix products of (1-b)."""
    return jnp.cumprod(1 - bits, axis=-1)


def _and_prefix(bits):
    """kary_and witness values: prefix products of b."""
    return jnp.cumprod(bits, axis=-1)


def _bound_block_512(norm_lo, norm_hi):
    """The 50 norm-bound witnesses for Falcon-512 in allocation order.

    norm value = norm_hi * 2^16 + norm_lo with norm_lo < 2^16.
    Mirrors the or/and tree of `range_proofs.rs:146-184` (see
    gadgets/range_proofs.py); witness order derived from left-to-right
    depth-first evaluation.
    """
    b_lo = _bits(norm_lo, 16)
    b_hi = _bits(norm_hi, 10)
    bits = jnp.concatenate([b_lo, b_hi], axis=-1)[..., :26]
    b = [bits[..., i] for i in range(26)]

    u = _nor_prefix(bits[..., 19:25])[..., 1:]   # u1..u5
    v_ = _and_prefix(bits[..., 16:19])[..., 1:]  # v1, v2
    up = _nor_prefix(bits[..., 6:10])[..., 1:]   # u'1..u'3
    k4 = (1 - b[3]) * (1 - b[4])
    vp = b[1] * b[2]

    u5 = u[..., -1]
    v2 = v_[..., -1]
    u3p = up[..., -1]
    a6 = k4 * (1 - vp)
    o6 = b[5] * (1 - a6)
    a5 = u3p * (1 - o6)
    o5 = b[10] * (1 - a5)
    a4 = (1 - b[11]) * (1 - o5)
    o4 = b[12] * (1 - a4)
    a3 = (1 - b[13]) * (1 - o4)
    o3 = b[14] * (1 - a3)
    a2 = (1 - b[15]) * (1 - o3)
    o2 = v2 * (1 - a2)
    a1 = u5 * (1 - o2)
    o1 = b[25] * (1 - a1)

    tail = jnp.stack(
        [k4, vp, a6, o6, a5, o5, a4, o4, a3, o3, a2, o2, a1, o1], axis=-1
    )
    return jnp.concatenate([bits, u, v_, up, tail], axis=-1)


def _bound_block_1024(norm_lo, norm_hi):
    """The 52 norm-bound witnesses for Falcon-1024 in allocation order
    (tree of `range_proofs.rs:235-270`)."""
    b_lo = _bits(norm_lo, 16)
    b_hi = _bits(norm_hi, 11)
    bits = jnp.concatenate([b_lo, b_hi], axis=-1)[..., :27]
    b = [bits[..., i] for i in range(27)]

    u = _nor_prefix(bits[..., 22:26])[..., 1:]    # u1..u3 (kary_or 22..25)
    v1 = b[20] * b[21]                            # kary_and 20..21
    up = _nor_prefix(bits[..., 14:20])[..., 1:]   # u'1..u'5 (kary_or 14..19)
    w1 = (1 - b[9]) * (1 - b[10])                 # kary_or 9..10
    x1 = b[7] * b[8]                              # kary_and 7..8
    y1 = (1 - b[5]) * (1 - b[6])                  # kary_or 5..6
    z1 = b[3] * b[4]                              # kary_and 3..4
    q1 = (1 - b[1]) * (1 - b[2])                  # kary_or 1..2

    u3 = u[..., -1]
    u5p = up[..., -1]
    o6 = z1 * (1 - q1)
    a6 = y1 * (1 - o6)
    o5 = x1 * (1 - a6)
    a5 = w1 * (1 - o5)
    o4 = b[11] * (1 - a5)
    a4 = (1 - b[12]) * (1 - o4)
    o3 = b[13] * (1 - a4)
    a3 = u5p * (1 - o3)
    o2 = v1 * (1 - a3)
    a2 = u3 * (1 - o2)
    o1 = b[26] * (1 - a2)

    tail = jnp.stack(
        [v1] + [w1, x1, y1, z1, q1]
        + [o6, a6, o5, a5, o4, a4, o3, a3, o2, a2, o1],
        axis=-1,
    )
    return jnp.concatenate([bits, u, tail[..., :1], up, tail[..., 1:]], axis=-1)


@dataclass
class WitnessBatch:
    """Device-resident witness values for a batch (compact segment form).

    Big NTT quotients are limb tensors (num_limbs, batch, n); everything
    else is int32.  `falcon_r1cs_tpu.witness.layout` interleaves into the
    canonical flat witness vector for export / bit-exact comparison.
    """

    params: FalconParams
    sig: jnp.ndarray            # (B, n)
    v: jnp.ndarray              # (B, n)
    range_v: jnp.ndarray        # (B, n, 27) int8 bits+chain
    sig_ntt_t: jnp.ndarray      # (L, B, n) limbs
    sig_ntt_b: jnp.ndarray      # (B, n)
    sig_ntt_tail: jnp.ndarray   # (B, n, 27) int8 bits+chain
    v_ntt_t: jnp.ndarray        # (L, B, n)
    v_ntt_b: jnp.ndarray        # (B, n)
    v_ntt_tail: jnp.ndarray     # (B, n, 27) int8
    pointwise: jnp.ndarray      # (B, n, 3) int32 [prod | t | c]
    pointwise_tail: jnp.ndarray  # (B, n, 27) int8 bits+chain
    norm_bits: jnp.ndarray      # (16, B, 2n) int8 bits|nor|and (feature-first)
    norm_vals: jnp.ndarray      # (2, B, 2n) int32 [select | square]
    bound: jnp.ndarray          # (B, 50|52) int8
    pk_ntt: jnp.ndarray         # (B, n) public input
    hm_ntt: jnp.ndarray         # (B, n) public input


def generate_witness_ntt(
    sig, pk_ntt, hm_ntt, params: FalconParams, backend: str = "xla"
):
    """All witness values of FalconNTTVerificationCircuit for a batch.

    Inputs: (B, n) int32 arrays: sig lifted to [0, q), pk and hm in NTT
    domain [0, q).  Pure function of its inputs; jit/pjit over a batch-
    sharded mesh.  backend: the hint-NTT implementation (ops/backend.py).
    """
    n = params.n
    sig = sig.astype(jnp.int32)
    pk_ntt = pk_ntt.astype(jnp.int32)
    hm_ntt = hm_ntt.astype(jnp.int32)

    # sig's NTT hints first: the hint kernel's reduced output sig_b IS the
    # clear NTT of sig, so the v derivation reuses it (one NTT saved)
    from ..ops.ntt_limb import intt_then_hints, ntt_hints

    sig_t, sig_b = ntt_hints(sig, params, backend)

    # v = hm - sig*pk mod (q, x^n+1)
    w = sub_mod_q(hm_ntt, mul_mod_q(sig_b, pk_ntt))
    v_t, v_b, v = intt_then_hints(w, params, backend)

    # range proof chains on v
    v_bits = _bits(v, 14)
    range_v = jnp.concatenate([v_bits, _lt_q_chain(v_bits, v)], axis=-1)
    sig_bits, sig_chain = _modq_block(sig_t, sig_b)
    v_bits_n, v_chain = _modq_block(v_t, v_b)
    sig_tail = jnp.concatenate([sig_bits, sig_chain], axis=-1)
    v_tail = jnp.concatenate([v_bits_n, v_chain], axis=-1)

    # pointwise: hm = v_ntt + sig_ntt*pk_ntt mod q
    prod = sig_b * pk_ntt                     # < q^2 < 2^27
    tot = v_b + prod
    t_pw, c_pw = fast_divmod_q(tot)
    pw_bits = _bits(c_pw, 14)
    pointwise = jnp.stack([prod, t_pw, c_pw], axis=-1)
    pointwise_tail = jnp.concatenate(
        [pw_bits, _lt_q_chain(pw_bits, c_pw)], axis=-1
    )

    # l2 norm over v || sig (feature-major: see _norm_block_t)
    coeffs = jnp.concatenate([v, sig], axis=-1)  # (B, 2n)
    norm_bits, sel, sq = _norm_block_t(coeffs)
    norm_vals = jnp.stack([sel, sq], axis=0)
    # exact 37-bit sum in int32 pairs
    sum_lo = jnp.sum(jnp.bitwise_and(sq, 0xFFFF), axis=-1)
    sum_hi = jnp.sum(sq >> 16, axis=-1)
    norm_lo = jnp.bitwise_and(sum_lo, 0xFFFF)
    norm_hi = sum_hi + (sum_lo >> 16)

    if n == 512:
        bound = _bound_block_512(norm_lo, norm_hi)
    else:
        bound = _bound_block_1024(norm_lo, norm_hi)

    return WitnessBatch(
        params=params,
        sig=sig,
        v=v,
        range_v=range_v,
        sig_ntt_t=sig_t,
        sig_ntt_b=sig_b,
        sig_ntt_tail=sig_tail,
        v_ntt_t=v_t,
        v_ntt_b=v_b,
        v_ntt_tail=v_tail,
        pointwise=pointwise,
        pointwise_tail=pointwise_tail,
        norm_bits=norm_bits,
        norm_vals=norm_vals,
        bound=bound,
        pk_ntt=pk_ntt,
        hm_ntt=hm_ntt,
    )


def jitted_engine(n: int):
    """jit-compiled witness generator for the given parameter set, on the
    hint-NTT backend the platform and runtime config select
    (ops/backend.py).  Cached per (n, backend), so a config change takes
    effect on the next lookup."""
    from ..ops.backend import configured_ntt_backend

    return _jitted_engine(n, configured_ntt_backend())


@functools.lru_cache(maxsize=None)
def _jitted_engine(n: int, backend: str):
    params = get_params(n)

    @jax.jit
    def run(sig, pk_ntt, hm_ntt):
        wb = generate_witness_ntt(sig, pk_ntt, hm_ntt, params, backend)
        return _seg_dict(wb)

    return run


def _seg_dict(wb):
    return {
        "sig": wb.sig, "v": wb.v, "range_v": wb.range_v,
        "sig_ntt_t": wb.sig_ntt_t, "sig_ntt_b": wb.sig_ntt_b,
        "sig_ntt_tail": wb.sig_ntt_tail,
        "v_ntt_t": wb.v_ntt_t, "v_ntt_b": wb.v_ntt_b,
        "v_ntt_tail": wb.v_ntt_tail,
        "pointwise": wb.pointwise, "pointwise_tail": wb.pointwise_tail,
        "norm_bits": wb.norm_bits, "norm_vals": wb.norm_vals,
        "bound": wb.bound,
        "pk_ntt": wb.pk_ntt, "hm_ntt": wb.hm_ntt,
    }
