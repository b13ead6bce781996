"""Fixed-width big-integer arithmetic as 16-bit limbs in int32 lanes.

The NTT gadget's bound-tracking invariant (SURVEY.md section 3.4,
`/root/reference/falcon-r1cs/src/gadgets/poly.rs:126-134`) caps every
witness-generation intermediate at 2^log_n * q^(log_n+1) < 2^164, so fixed
L=11 limbs of 16 bits (176 bits) are exact for both parameter sets -- no
arbitrary-precision arithmetic (the reference's num-bigint hints,
`arithmetics.rs:73-80`) is needed on device.

Layout: the limb axis LEADS -- tensors are (L, ...batch/coeff...) int32 --
so the trailing two axes stay (batch, n), contiguous per limb row, with
no padding waste.  All ops are elementwise over the trailing axes and
jit/vmap/shard_map-friendly.

Value representations:
  normalized: every limb in [0, 2^16)
  redundant:  int32 limbs, possibly negative (|limb| < 2^30), produced by
              butterfly add/sub; must be normalized before the next multiply
              so limb*s fits int32 (s < q < 2^14).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NUM_LIMBS = 11  # 176 bits >= 164-bit bound


# -- host converters --------------------------------------------------------

def int_to_limbs(value: int, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    out = np.empty(num_limbs, dtype=np.int32)
    for k in range(num_limbs):
        out[k] = value & LIMB_MASK
        value >>= LIMB_BITS
    if value:
        raise OverflowError("value does not fit in limbs")
    return out


def ints_to_limbs(values, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    """(...,) python-int array -> (num_limbs, ...) int32."""
    arr = np.asarray(values, dtype=object)
    out = np.empty((num_limbs,) + arr.shape, dtype=np.int32)
    flat = arr.reshape(-1)
    oflat = out.reshape(num_limbs, -1)
    for i, v in enumerate(flat):
        v = int(v)
        for k in range(num_limbs):
            oflat[k, i] = v & LIMB_MASK
            v >>= LIMB_BITS
        if v:
            raise OverflowError("value does not fit in limbs")
    return out


def limbs_to_ints(limbs: np.ndarray) -> np.ndarray:
    """(num_limbs, ...) -> (...,) object array of python ints."""
    limbs = np.asarray(limbs)
    out = np.zeros(limbs.shape[1:], dtype=object)
    for k in range(limbs.shape[0] - 1, -1, -1):
        out = (out << LIMB_BITS) + limbs[k].astype(object)
    return out


# -- device ops -------------------------------------------------------------

def normalize(x):
    """Carry-propagate redundant int32 limbs to normalized [0, 2^16) limbs.

    Sequential scan over the (leading, static-length) limb axis; works with
    negative intermediate limbs via arithmetic right shift, provided the
    total value is nonnegative (always true here: bounds are maintained so
    every tracked value is a nonnegative integer below the stage bound).
    """
    L = x.shape[0]
    out = []
    carry = jnp.zeros_like(x[0])
    for k in range(L):
        t = x[k] + carry
        out.append(jnp.bitwise_and(t, LIMB_MASK))
        carry = jnp.right_shift(t, LIMB_BITS)  # arithmetic shift on int32
    return jnp.stack(out)


def from_small(values, num_limbs: int = NUM_LIMBS):
    """Embed int32 values < 2^16 as normalized limb tensors."""
    zeros = jnp.zeros_like(values)
    return jnp.stack([values] + [zeros] * (num_limbs - 1))


def mul_small(x, s):
    """normalized x times broadcastable int32 s < 2^15 -> normalized.

    Per-limb product <= (2^16-1)(2^15-1) < 2^31, then one carry pass.
    """
    return normalize(x * s)


def add(x, y):
    """limbwise add (either operand may be redundant within bounds)."""
    return x + y


def sub_const_minus(c_limbs, x):
    """c - x for a constant limb vector c >= x: redundant signed result."""
    return c_limbs.reshape(c_limbs.shape + (1,) * (x.ndim - 1)) - x


def divmod_q(x):
    """(t, r) with x = t*q + r, 0 <= r < q, for normalized x.

    Base-2^16 long division from the top limb: r < q < 2^14 so the running
    numerator r*2^16 + limb < 2^30 fits int32; each quotient limb < 2^16.
    Returns t as (L, ...) normalized limbs and r as (...,) int32.
    """
    from .modq import divmod_q as _divmod_q_fast

    L = x.shape[0]
    r = jnp.zeros_like(x[0])
    t = []
    for k in range(L - 1, -1, -1):
        cur = (r << LIMB_BITS) + x[k]
        tk, r = _divmod_q_fast(cur)
        t.append(tk)
    t.reverse()
    return jnp.stack(t), r

