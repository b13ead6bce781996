"""BLS12-381 base-field (Fq, 381-bit) lazy Montgomery arithmetic on the device.

The Groth16 prover's MSMs are the hot path of proving; this module is
the device MSM's core primitive (snark/tpu_msm.py):
batched Montgomery multiplication over signed 12-bit limb tensors with
NO cross-lane carry/borrow scans anywhere in the data path.

Why scan-free matters: an exact-canonical design (word-serial CIOS, or
product-scan + Kogge-Stone carry fix + conditional-subtract per op) was
built first and measured.  Composed into the elliptic group law, XLA
compiled each Jacobian point-add to ~285 ms on CPU (~50x the sum of its
parts) and took minutes per MSM compile — the comparison-heavy carry
scans defeat both fusion and codegen.  The lazy design below keeps every
op elementwise/shift-local (pure vector work) and recovers exact
carries arithmetically instead of structurally.

Representation ("relaxed" limbs):
  (..., 35) int32; value = sum l_i 2^(12 i); limbs SIGNED with
  |l_i| <= 2^12 + 2 and the top (headroom) limb |l_34| small.  A value's
  representation is not unique and may be negative; everything downstream
  is mod-q arithmetic, so representatives are free until a comparison.
  Montgomery domain: x is stored as x * 2^408 mod q (R = 2^408 > 2^396
  gives ~2^27 of value headroom, which makes the bound algebra trivially
  stable: mont_mul contracts |value| to ~1.0005 q for any inputs below
  ~2^13 q).

Core tricks:
  - `_big_mul`: 35x35 outer product folded along anti-diagonals with the
    skew-reshape trick (pad rows, flatten, re-view one column narrower:
    row i lands shifted by i) — no shift-add chain, no dense collector.
  - masked shift-add rounds (`_semi`) redistribute limbs below 2^12+2;
    they are value-preserving UNCONDITIONALLY (the top column is left
    unmasked so no carry/borrow ever falls off the buffer).  Product
    buffers carry two spare columns; `mont_mul` folds them back into the
    result's headroom limb (the fold is <= 2 by the value bound).
  - the exact divide-by-R in Montgomery reduction: T + m*q is an exact
    multiple of R; its low 34 limbs form k*R for a small k recovered by
    one float32 weighted sum (error << 0.5, see `_carry_estimate`), so
    the shift is a slice plus one scalar add — no carry scan.
  - equality/zero tests (`is_zero_mod_q`): subtract the f32-estimated
    quotient alpha*q, then prove the remainder is literally zero via CRT
    residues modulo 30 13-bit primes (elementwise int32 products + sum,
    f32-reciprocal mod-p) — product of the primes exceeds q, so all-zero
    residues of a |z| < q/2 value imply z == 0.
  - no matrix products anywhere: every limb product is elementwise int32
    (exact on every backend; a GPU dot_general may compute in floating
    point or autotune thousands of GEMMs at compile time).

Reference role: replaces the host/C Pippenger field core for the
device MSM (snark/tpu_msm.py); differentially tested against the
pure-Python BLS12-381 implementation in tests/test_tpu_msm.py.
"""

from __future__ import annotations

import numpy as np

from ..snark.bls12_381 import P as Q381

LIMB = 12
MASK = (1 << LIMB) - 1
NSIG = 34            # significant limbs: 2^408 > q * 2^27
NL = NSIG + 1        # plus one headroom limb
PROD = 2 * NL + 1    # product buffer: 69 anti-diagonals + 2 spare columns
R_BITS = LIMB * NSIG  # Montgomery R = 2^408
R_MONT = 1 << R_BITS
R2 = R_MONT * R_MONT % Q381
MU = (-pow(Q381, -1, R_MONT)) % R_MONT  # -q^{-1} mod 2^408


def _to_limb_vec(v: int, n: int) -> np.ndarray:
    return np.asarray([(v >> (LIMB * k)) & MASK for k in range(n)],
                      dtype=np.int32)


Q_LIMBS = _to_limb_vec(Q381, NL)
MU_LIMBS = _to_limb_vec(MU, NSIG)  # mu < 2^408
# f32 weights recovering k = value(low 34 limbs) / 2^408 (|k| <= 2):
# terms are exact powers of two times <= 2^13 ints, so the sum's error
# is bounded by 34 roundings of magnitude <= 2^-23 — far below 0.5.
_CARRY_W = np.asarray(
    [float(2.0 ** (LIMB * i - R_BITS)) for i in range(NSIG)], dtype=np.float32
)
# f32 weights estimating value / q (exact to ~2^-17 relative for the
# |value| <= 2^16 q range used by is_zero_mod_q)
_ALPHA_W = np.asarray(
    [float((1 << (LIMB * i)) / Q381) for i in range(NL)], dtype=np.float32
)

# 30 distinct 13-bit primes; their product (~2^389.8) exceeds q, so a
# value in (-q/2, q/2) with all residues zero is zero.
_CRT_PRIMES = []
_c = (1 << 13) - 1
while len(_CRT_PRIMES) < 30:
    for _d in range(3, 91, 2):
        if _c % _d == 0:
            break
    else:
        _CRT_PRIMES.append(_c)
    _c -= 2
_CRT_PRIMES = np.asarray(_CRT_PRIMES, dtype=np.int32)
_ZCOLS = NL + 2  # zero-test scratch width (2 spare columns for _semi)
_CRT_W = np.stack(
    [
        np.asarray(
            [pow(1 << (LIMB * i), 1, int(p)) for i in range(_ZCOLS)],
            dtype=np.int32,
        )
        for p in _CRT_PRIMES
    ],
    axis=1,
)  # (_ZCOLS, 30)
_CRT_RECIP = (1.0 / _CRT_PRIMES.astype(np.float64)).astype(np.float32)


def int_to_limbs(vals) -> np.ndarray:
    """list[int] -> (B, 35) int32 canonical (nonneg, < 2^12) limbs."""
    out = np.zeros((len(vals), NL), dtype=np.int32)
    for i, v in enumerate(vals):
        v = int(v) % Q381
        for k in range(NL):
            out[i, k] = v & MASK
            v >>= LIMB
    return out


def limbs_to_int(row) -> int:
    """Exact signed evaluation (python bigint); callers reduce mod q."""
    return sum(int(c) << (LIMB * k) for k, c in enumerate(np.asarray(row)))


def _shift_up(x, sh: int):
    """Move limb k to k+sh (toward higher significance), zero-fill low.
    The top `sh` limbs fall off — callers guarantee they are zero."""
    import jax.numpy as jnp

    pad = jnp.zeros(x.shape[:-1] + (sh,), dtype=x.dtype)
    return jnp.concatenate([pad, x[..., : x.shape[-1] - sh]], axis=-1)


def _semi_round(t):
    """One masked shift-add round: t_k -> (t_k & MASK) + (t_{k-1} >> 12)
    for k < top; the TOP column is left unmasked (it keeps its own full
    value plus the incoming carry), so the round is value-preserving
    UNCONDITIONALLY — including negative top limbs, whose arithmetic
    shift would otherwise emit a -1 carry off the end of the buffer.
    Top-column growth per round is just the incoming carry; every call
    site's buffer puts only small residue there (see mont_mul)."""
    import jax.numpy as jnp

    low = t & MASK
    carry = t >> LIMB
    out = low + _shift_up(carry, 1)
    top = t[..., -1] + carry[..., -2]
    return jnp.concatenate([out[..., :-1], top[..., None]], axis=-1)


def _semi(t, rounds: int = 3):
    """Semi-normalize: |limbs| < 2^29 -> <= 2^12 + 2 in three rounds
    (carry magnitudes shrink 2^17 -> 2^5 -> 2 across rounds)."""
    for _ in range(rounds):
        t = _semi_round(t)
    return t


def _big_mul(a, b, ncols: int = PROD):
    """Limb product: (..., na) x (nb,)|(..., nb) -> (..., ncols) raw
    anti-diagonal sums T[c] = sum_{i+j=c} a_i b_j.  Entries are exact in
    int32: 35 * (2^12 + 2)^2 < 2^29.1.  The row-shift uses the
    skew-reshape trick (see module docstring): pad rows to width
    w = na + nb, flatten, re-view at width w - 1 so row i lands shifted
    by i columns."""
    import jax.numpy as jnp

    na = a.shape[-1]
    nb = b.shape[-1]
    prod = a[..., :, None] * b[..., None, :]          # (..., na, nb)
    w = na + nb
    padded = jnp.concatenate(
        [prod, jnp.zeros(prod.shape[:-1] + (w - nb,), prod.dtype)], axis=-1
    )
    flat = padded.reshape(padded.shape[:-2] + (na * w,))
    skew = flat[..., : na * (w - 1)].reshape(flat.shape[:-1] + (na, w - 1))
    out = skew.sum(axis=-2)  # na + nb - 1 active columns
    if ncols <= w - 1:
        return out[..., :ncols]
    pad = jnp.zeros(out.shape[:-1] + (ncols - (w - 1),), out.dtype)
    return jnp.concatenate([out, pad], axis=-1)


def _carry_estimate(s_low):
    """k = value(s_low) / 2^408 for a 34-limb slice whose value is an
    exact multiple of 2^408 (|k| <= 2).  One f32 weighted sum + round."""
    import jax.numpy as jnp

    est = (s_low.astype(jnp.float32) * jnp.asarray(_CARRY_W)).sum(axis=-1)
    return jnp.round(est).astype(jnp.int32)


def mont_mul(a, b):
    """Batched lazy Montgomery product: (..., 35) x (..., 35) -> (..., 35).

    result = (T + m q)/R with T = a b and m = T mu mod R.  All three
    products run through `_big_mul` into a 71-column buffer; with input
    limbs <= 2^12 + 2 (headroom limb <= ~2^10) the `_semi` carries die
    out two columns past the last active anti-diagonal, so columns 69-70
    stay zero and nothing is ever dropped: T, u and s are EXACT
    integers.  s = T + u is an exact multiple of R; `_carry_estimate`
    recovers the low half's contribution and the divide-by-R is a
    slice.  Output |value| <= ~1.0005 q for |inputs| <= 2^13 q — the
    representation is closed under the group law with huge margin."""
    import jax.numpy as jnp

    t_full = _semi(_big_mul(a, b))                     # exact T, 71 cols
    m = _semi(_big_mul(t_full[..., :NSIG], MU_LIMBS))[..., :NSIG]
    # m's spill columns are dropped: multiples of R vanish mod R, and
    # the rep overshoot (|m| <= R (1 + 2^-11)) is absorbed by headroom
    m_ext = jnp.concatenate(
        [m, jnp.zeros(m.shape[:-1] + (NL - NSIG,), m.dtype)], axis=-1
    )
    u = _semi(_big_mul(m_ext, Q_LIMBS))                # exact m*q
    s = _semi_round(t_full + u)                        # exact, == 0 mod R
    k = _carry_estimate(s[..., :NSIG])
    hi = s[..., NSIG : NSIG + NL]                      # exact shift by R
    # fold the spill columns (69, 70 — borrow/carry residue that walked
    # past the last active anti-diagonal) into the headroom limb.  The
    # fold is provably tiny: |value(hi + spill)| = |s/R - k| <= ~1.5 q,
    # and the 34 limbs below the top contribute at most ~1.0005 * 2^408,
    # so |top + spill-fold| <= 2 — NOT the 2^29 a naive per-column bound
    # suggests.  Dropping these columns (the original design) corrupted
    # any product whose relaxed inputs carried a negative borrow chain.
    spill = s[..., NSIG + NL :]
    top = (
        hi[..., -1]
        + (spill[..., 0] << LIMB)
        + (spill[..., 1] << (2 * LIMB))
    )
    return jnp.concatenate(
        [hi[..., 0:1] + k[..., None], hi[..., 1:-1], top[..., None]],
        axis=-1,
    )


def add_mod(a, b):
    """Lazy add: limbwise sum + one redistribution round.  Signed,
    no reduction — values accumulate (bounds contract at the next mul)."""
    return _semi_round(a + b)


def sub_mod(a, b):
    """Lazy subtract: limbwise difference (negative limbs are fine)."""
    return _semi_round(a - b)


def to_mont(a_std):
    import jax.numpy as jnp

    r2 = jnp.asarray(int_to_limbs([R2])[0])
    return mont_mul(a_std, jnp.broadcast_to(r2, a_std.shape))


def from_mont(a_mont):
    import jax.numpy as jnp

    one = np.zeros((NL,), dtype=np.int32)
    one[0] = 1
    return mont_mul(a_mont, jnp.broadcast_to(jnp.asarray(one), a_mont.shape))


def is_zero_mod_q(t):
    """Exact (t == 0 mod q) for relaxed reps with |value| <= ~2^15 q.

    alpha = round(value/q) via one f32 weighted sum (exact: the estimate
    error is ~2^-17 relative), z = t - alpha q is then in (-q/2, q/2) and
    zero iff t == 0 mod q.  z's 30 CRT residues mod 13-bit primes (int32
    products + sum, f32-reciprocal mod) are all zero iff z == 0, since the
    primes' product exceeds q.  Elementwise and sums only: no carry scans."""
    import jax.numpy as jnp

    alpha = jnp.round(
        (t.astype(jnp.float32) * jnp.asarray(_ALPHA_W)).sum(axis=-1)
    ).astype(jnp.int32)
    z = t - alpha[..., None] * jnp.asarray(Q_LIMBS)
    z = jnp.concatenate(
        [z, jnp.zeros(z.shape[:-1] + (_ZCOLS - NL,), z.dtype)], axis=-1
    )
    z = _semi(z, rounds=3)  # |limbs| <= 2^12 + 2, spare cols absorb tops
    # elementwise products and an int32 sum, not a dot: |r| < 2^30.3 is
    # exact in int32, while a GPU dot may run in floating point
    r = (z[..., :, None] * jnp.asarray(_CRT_W)).sum(axis=-2)
    kq = jnp.round(r.astype(jnp.float32) * jnp.asarray(_CRT_RECIP)).astype(
        jnp.int32
    ) * jnp.asarray(_CRT_PRIMES)
    return ((r - kq) == 0).all(axis=-1)


def eq_mod_q(a, b):
    """Exact value equality mod q of two relaxed reps."""
    return is_zero_mod_q(sub_mod(a, b))
