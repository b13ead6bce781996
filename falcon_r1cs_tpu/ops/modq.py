"""Division-free mod-q arithmetic for int32 lanes.

For the ranges these circuits need (x < 2^30), an f32 reciprocal multiply
gives the quotient within +-1 (f32 ulp at 2^30 is 2^6, so the quotient
error is < (2^6 + Q/2)/Q < 1), fixed up with two predicated corrections --
~8 cheap elementwise ops, exact for all inputs in range, that fuse into
their neighbours instead of a long division per element.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..params import Q

# a numpy scalar, not a jax Array: a module-level device array captured
# by several jitted programs makes this JAX (0.9.0) pass the constants of
# a later specialization as arguments its fast call path then omits
# ("compiled program expected N buffers" on the second call)
_INV_Q_F32 = np.float32(1.0 / Q)


def divmod_q(x):
    """(x // q, x % q) for int32 0 <= x < 2^30, division-free and exact."""
    t = jnp.floor(x.astype(jnp.float32) * _INV_Q_F32).astype(jnp.int32)
    r = x - t * Q
    over = (r >= Q).astype(jnp.int32)
    t = t + over
    r = r - over * Q
    under = (r < 0).astype(jnp.int32)
    t = t - under
    r = r + under * Q
    return t, r


def mod_q(x):
    """x % q for int32 0 <= x < 2^30."""
    return divmod_q(x)[1]


def mul_mod_q(a, b):
    """a*b % q for 0 <= a, b < q (product < 2^28)."""
    return mod_q(a * b)


def add_mod_q(a, b):
    """(a + b) % q for 0 <= a, b < q: one predicated subtract."""
    s = a + b
    return jnp.where(s >= Q, s - Q, s)


def sub_mod_q(a, b):
    """(a - b) % q for 0 <= a, b < q: one predicated add."""
    d = a - b
    return jnp.where(d < 0, d + Q, d)
