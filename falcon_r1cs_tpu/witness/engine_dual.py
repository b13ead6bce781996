"""Batched witness engine for the dual-NTT verification circuit.

Witness layout (allocation order of FalconDualNTTVerificationCircuit, per
signature; n = N):
  sig_pos (n) | sig_neg (n)
  sig orthogonality: n mul wires (pos_i*neg_i partial products) |
      is_zero pair [is_neq bit, multiplier]
  v_pos (n) | v_neg (n) | v orthogonality (n + 2)
  sig_pos NTT mod_q (n, 29) | sig_neg NTT (n, 29)
  v_pos NTT (n, 29) | v_neg NTT (n, 29)
  pointwise (n, 60): [mul_L, t_L, b_L, 27] | [mul_R, t_R, b_R, 27]
                     (stored split: vals (6, B, n) i32 + two int8 tails)
  norm squares (4n)
  bound (50 | 52)

The is_zero multiplier is 1 when the accumulated pos*neg product is zero
(always, for disjoint-support duals) -- arkworks' equal-branch convention
(PARITY_NOTES.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..falcon.ntt import intt_jax, ntt_jax
from ..ops.modq import divmod_q as fast_divmod_q, mul_mod_q, sub_mod_q
from ..ops.ntt_limb import ntt_with_hints
from ..params import FalconParams, Q, get_params
from .engine import (
    _bits,
    _bound_block_1024,
    _bound_block_512,
    _lt_q_chain,
)

_HALF = 6144


def _dual_split(c):
    """[0, q) coeffs -> (pos, neg) with disjoint support (poly.py centering)."""
    pos = jnp.where(c < _HALF, c, 0)
    neg = jnp.where(c < _HALF, 0, Q - c)
    return pos, neg


def _modq_tail(b):
    bits = _bits(b, 14)
    return jnp.concatenate([bits, _lt_q_chain(bits, b)], axis=-1)


def generate_witness_dual(
    sig_signed, pk_ntt, hm_ntt, params: FalconParams, backend: str = "xla"
):
    """All witness values of FalconDualNTTVerificationCircuit for a batch.

    sig_signed: (B, n) int32 SIGNED signature coefficients.
    Returns a dict of segment tensors (see module docstring)."""
    n = params.n
    sig_signed = sig_signed.astype(jnp.int32)
    pk_ntt = pk_ntt.astype(jnp.int32)
    hm_ntt = hm_ntt.astype(jnp.int32)

    sig_pos = jnp.where(sig_signed >= 0, sig_signed, 0)
    sig_neg = jnp.where(sig_signed < 0, -sig_signed, 0)

    # sig NTT hints first: sig_lifted = (pos - neg) mod q and the NTT is
    # linear, so NTT(sig) = (sp_b - sn_b) mod q -- the hint kernels'
    # reduced outputs replace a separate clear NTT for the v derivation
    from ..ops.ntt_limb import ntt_hints

    sp_t, sp_b = ntt_hints(sig_pos, params, backend)
    sn_t, sn_b = ntt_hints(sig_neg, params, backend)

    # v = hm - sig*pk mod (q, x^n+1) via NTT domain
    sig_ntt = sub_mod_q(sp_b, sn_b)
    v = intt_jax(sub_mod_q(hm_ntt, mul_mod_q(sig_ntt, pk_ntt)), n)
    v_pos, v_neg = _dual_split(v)

    # orthogonality mul wires: partial products pos_i * neg_i (all zero for
    # disjoint support, but allocation order is the contract)
    sig_orth = sig_pos * sig_neg          # (B, n)
    v_orth = v_pos * v_neg

    vp_t, vp_b = ntt_hints(v_pos, params, backend)
    vn_t, vn_b = ntt_hints(v_neg, params, backend)

    # pointwise: left = mod_q(hm + vn + sn*pk), right = mod_q(vp + sp*pk)
    mul_l = sn_b * pk_ntt
    t_l, b_l = fast_divmod_q(hm_ntt + vn_b + mul_l)
    mul_r = sp_b * pk_ntt
    t_r, b_r = fast_divmod_q(vp_b + mul_r)
    # value/bit split (engine.py layout note): 54 of the 60 pointwise
    # slots are int8 bits/chains; materializing them in a single int32
    # (B, n, 60) concat would write 4x their bytes
    pw_vals = jnp.stack([mul_l, t_l, b_l, mul_r, t_r, b_r], axis=0)
    pw_tail_l = _modq_tail(b_l)
    pw_tail_r = _modq_tail(b_r)

    # norm: squares over v_pos || v_neg || sig_pos || sig_neg
    coeffs = jnp.concatenate([v_pos, v_neg, sig_pos, sig_neg], axis=-1)
    sq = coeffs * coeffs
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
        "sig_pos": sig_pos, "sig_neg": sig_neg, "sig_orth": sig_orth,
        "v_pos": v_pos, "v_neg": v_neg, "v_orth": v_orth,
        "sp_t": sp_t, "sp_b": sp_b, "sp_tail": _modq_tail(sp_b),
        "sn_t": sn_t, "sn_b": sn_b, "sn_tail": _modq_tail(sn_b),
        "vp_t": vp_t, "vp_b": vp_b, "vp_tail": _modq_tail(vp_b),
        "vn_t": vn_t, "vn_b": vn_b, "vn_tail": _modq_tail(vn_b),
        "pointwise_vals": pw_vals,        # (6, B, n) int32, feature-first
        "pointwise_tail_l": pw_tail_l,    # (B, n, 27) int8
        "pointwise_tail_r": pw_tail_r,
        "norm_sq": sq, "bound": bound,
        "pk_ntt": pk_ntt, "hm_ntt": hm_ntt,
    }


def jitted_engine_dual(n: int):
    """Backend policy identical to engine.jitted_engine; cached per
    (n, backend)."""
    from ..ops.backend import configured_ntt_backend

    return _jitted_engine_dual(n, configured_ntt_backend())


@functools.lru_cache(maxsize=None)
def _jitted_engine_dual(n: int, backend: str):
    params = get_params(n)
    return jax.jit(
        lambda sig, pk, hm: generate_witness_dual(
            sig, pk, hm, params, backend
        )
    )


def interleave_witness_dual(seg: dict, params: FalconParams) -> np.ndarray:
    """Assemble (B, num_witness) object array in allocation order."""
    from ..ops.limbs import limbs_to_ints

    n = params.n
    o = lambda k: np.asarray(seg[k], dtype=object)
    B = o("sig_pos").shape[0]

    def orth_pair():
        # is_zero: [is_neq bit (0 for valid), multiplier (=1 equal-branch)]
        z = np.zeros((B, 1), dtype=object)
        one = np.ones((B, 1), dtype=object)
        return z, one

    def modq_seg(tk, bk, tailk):
        t_ints = limbs_to_ints(np.asarray(seg[tk]))
        out = np.empty((B, n, 29), dtype=object)
        out[:, :, 0] = t_ints
        out[:, :, 1] = o(bk)
        out[:, :, 2:] = o(tailk)
        return out.reshape(B, -1)

    z1, one1 = orth_pair()
    z2, one2 = orth_pair()
    # re-interleave the 60-wide pointwise block from the split segments
    pw = np.empty((B, n, 60), dtype=object)
    vals = o("pointwise_vals")
    pw[:, :, 0], pw[:, :, 1], pw[:, :, 2] = vals[0], vals[1], vals[2]
    pw[:, :, 3:30] = o("pointwise_tail_l")
    pw[:, :, 30], pw[:, :, 31], pw[:, :, 32] = vals[3], vals[4], vals[5]
    pw[:, :, 33:] = o("pointwise_tail_r")
    parts = [
        o("sig_pos"), o("sig_neg"), o("sig_orth"), z1, one1,
        o("v_pos"), o("v_neg"), o("v_orth"), z2, one2,
        modq_seg("sp_t", "sp_b", "sp_tail"),
        modq_seg("sn_t", "sn_b", "sn_tail"),
        modq_seg("vp_t", "vp_b", "vp_tail"),
        modq_seg("vn_t", "vn_b", "vn_tail"),
        pw.reshape(B, -1),
        o("norm_sq"),
        o("bound"),
    ]
    return np.concatenate(parts, axis=1)
