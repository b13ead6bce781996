"""G1 multi-scalar multiplication on the device (the Groth16 prover's hot
loop), in plain JAX.

Pippenger over jax primitives, built on the batched Montgomery Fq limb
arithmetic in ops/fq_mont.py:

  per 12-bit window:  sort points by bucket digit  ->  WORK-EFFICIENT
  reduce-by-key (`_bucket_reduce`): a binary merge tree over the sorted
  run costing exactly ONE complete-Jacobian point_add per merge (n-1
  adds total) whose per-merge "bridge" sum closes the segment spanning
  the merge boundary; every bucket's total is scattered exactly once,
  at the unique merge where both its ends become interior  ->  chunked
  serial suffix scans (`_weighted_bucket_sum`, ~3*nb adds) for the
  classic  sum_d d*B_d = sum of suffix sums  identity  ->  fold the 22
  windows with 12 doublings between them.

An earlier revision used Hillis-Steele segmented scans for both phases;
those are log-depth but WORK-INEFFICIENT — n*log2(n) point adds per
window (2.2M at n=2^17 vs the tree's 131k) plus nb*log2(nb) for the
bucket phase — a ~17x work inflation over host Pippenger that the tree
removes.  All control flow remains data-independent (sorts, strided
slices, where-selects, drop-mode scatters), so the whole MSM compiles
to one XLA program per (n, window).  Sharding the point axis
batch-splits the MSM across a mesh (`g1_msm_tpu_sharded`).

Montgomery-domain conversion of the input points runs ON DEVICE (one
`to_mont` mul per coordinate inside the jit); the host side is pure
vectorized numpy bit-slicing of the u64 limb arrays — no Python bigint
loops at prover scale.

The prover's default G1 backend is the native C library
(snark/backend_policy.py); this module is the device path, selected with
`g1_backend="tpu"` and differentially tested against the native and
pure-Python backends (tests/test_tpu_msm.py).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops import fq_mont as fq
from .bls12_381 import P as Q381, R as FR_R

WINDOW = 12
NW = (255 + WINDOW - 1) // WINDOW  # 22


_sub_mod = fq.sub_mod


def _dbl_small(a, times=1):
    out = a
    for _ in range(times):
        out = fq.add_mod(out, out)
    return out


def _eq(a, b):
    """Value equality of two relaxed limb reps (representations are not
    unique — limb-wise comparison would miss equal values)."""
    return fq.eq_mod_q(a, b)


def point_double(pt):
    """Jacobian doubling (dbl-2007-bl); pt = (X, Y, Z, inf)."""
    X, Y, Z, inf = pt
    mul = fq.mont_mul
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    t = fq.add_mod(X, B)
    t = mul(t, t)
    t = _sub_mod(_sub_mod(t, A), C)
    D = _dbl_small(t)
    E = fq.add_mod(_dbl_small(A), A)
    F = mul(E, E)
    X3 = _sub_mod(F, _dbl_small(D))
    Y3 = _sub_mod(mul(E, _sub_mod(D, X3)), _dbl_small(C, 3))
    Z3 = _dbl_small(mul(Y, Z))
    return (X3, Y3, Z3, inf)


def point_add(p1, p2):
    """Complete Jacobian addition: the generic chord and the tangent
    (doubling) paths are both evaluated and the correct one selected —
    data-independent control flow for XLA."""
    import jax.numpy as jnp

    X1, Y1, Z1, inf1 = p1
    X2, Y2, Z2, inf2 = p2
    mul = fq.mont_mul
    Z1Z1 = mul(Z1, Z1)
    Z2Z2 = mul(Z2, Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2), Z2Z2)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    H = _sub_mod(U2, U1)
    HH = _dbl_small(H)
    I = mul(HH, HH)
    J = mul(H, I)
    rr = _dbl_small(_sub_mod(S2, S1))
    V = mul(U1, I)
    X3 = _sub_mod(_sub_mod(mul(rr, rr), J), _dbl_small(V))
    Y3 = _sub_mod(mul(rr, _sub_mod(V, X3)), _dbl_small(mul(S1, J)))
    Z3 = _dbl_small(mul(mul(Z1, Z2), H))

    same_x = _eq(U1, U2)
    same_y = _eq(S1, S2)
    dbl = point_double(p1)
    use_dbl = same_x & same_y & ~inf1 & ~inf2
    is_inf3 = (same_x & ~same_y & ~inf1 & ~inf2) | (inf1 & inf2)

    def sel(cond, a, b):
        return jnp.where(cond[..., None], a, b)

    X3 = sel(use_dbl, dbl[0], X3)
    Y3 = sel(use_dbl, dbl[1], Y3)
    Z3 = sel(use_dbl, dbl[2], Z3)
    X3 = sel(inf1, X2, sel(inf2, X1, X3))
    Y3 = sel(inf1, Y2, sel(inf2, Y1, Y3))
    Z3 = sel(inf1, Z2, sel(inf2, Z1, Z3))
    return (X3, Y3, Z3, is_inf3)


def _sel_pt(cond, a, b):
    """Pointwise select between two point tuples by a (m,) bool."""
    import jax.numpy as jnp

    return (
        jnp.where(cond[..., None], a[0], b[0]),
        jnp.where(cond[..., None], a[1], b[1]),
        jnp.where(cond[..., None], a[2], b[2]),
        jnp.where(cond, a[3], b[3]),
    )


def _scatter_pt(bufs, key, val, valid, nb: int):
    """Write point rows into the dense bucket arrays; invalid rows are
    redirected out of range and dropped (each bucket is written at most
    once across the whole reduction, so plain set scatters suffice)."""
    import jax.numpy as jnp

    bx, by, bz, binf = bufs
    idx = jnp.where(valid, key, nb).astype(jnp.int32)
    vx, vy, vz, vinf = val
    bx = bx.at[idx].set(vx, mode="drop")
    by = by.at[idx].set(vy, mode="drop")
    bz = bz.at[idx].set(vz, mode="drop")
    binf = binf.at[idx].set(vinf, mode="drop")
    return (bx, by, bz, binf)


def _bucket_reduce(pt, keys, nb: int, add=point_add):
    """Dense bucket sums of a KEY-SORTED point run, in n-1 point adds.

    Binary merge tree.  Each node summarizes a contiguous range by
    (H, T, kf, kl): the sum of its first segment, the sum of its last
    segment, and the first/last keys (sortedness makes kf == kl imply a
    single-segment node, so H == T == total there).  Merging left|right
    costs exactly one point_add — bridge = T_left + H_right, the sum of
    the segment spanning the boundary; every other combination reduces
    to a select on it:

      merged.H = (left single-segment and bridge same-key) ? bridge : left.H
      merged.T = (right single-segment and same-key) ? bridge : right.T

    A segment's total is EMITTED (scattered to its bucket) at the unique
    merge where both its ends become interior: the bridged segment when
    neither side is single-segment, the left tail / right head when the
    boundary keys differ; the root's H and T segments are emitted last.
    Each bucket is therefore written at most once, so the scatters are
    plain last-write sets with drop-mode masking.

    Work: exactly one point_add per merge at halving widths — n-1 adds
    total, vs n*log2(n) for a segmented Hillis-Steele scan.
    """
    import jax.numpy as jnp

    bufs = (
        jnp.zeros((nb, fq.NL), jnp.int32),
        jnp.zeros((nb, fq.NL), jnp.int32),
        jnp.zeros((nb, fq.NL), jnp.int32),
        jnp.ones((nb,), bool),
    )
    H = T = pt
    kf = kl = keys
    m = keys.shape[0]
    assert m & (m - 1) == 0, "_bucket_reduce requires power-of-two length"
    while m > 1:
        lH = tuple(a[0::2] for a in H)
        rH = tuple(a[1::2] for a in H)
        lT = tuple(a[0::2] for a in T)
        rT = tuple(a[1::2] for a in T)
        lkf, rkf = kf[0::2], kf[1::2]
        lkl, rkl = kl[0::2], kl[1::2]
        bridge = add(lT, rH)
        same = lkl == rkf
        ls = lkf == lkl  # left node spans a single segment
        rs = rkf == rkl
        H = _sel_pt(same & ls, bridge, lH)
        T = _sel_pt(same & rs, bridge, rT)
        # left-tail/bridged segment: complete unless it still touches an
        # edge of the merged node ( ~ls rules out the left edge; same&rs
        # would extend it to the right edge)
        valA = _sel_pt(same, bridge, lT)
        bufs = _scatter_pt(bufs, lkl, valA, ~ls & ~(same & rs), nb)
        # right-head segment: its left end becomes interior here; it is
        # complete iff it already ended inside the right node
        bufs = _scatter_pt(bufs, rkf, rH, ~same & ~rs, nb)
        kf, kl = lkf, rkl
        m //= 2
    bufs = _scatter_pt(bufs, kf, H, jnp.ones((1,), bool), nb)
    bufs = _scatter_pt(bufs, kl, T, kl != kf, nb)
    return bufs


def _tree_sum(pt, add=point_add):
    """Fold a (power-of-two) leading axis by pairwise point_add.  Works
    at any rank: leaves are (m, ..., NL) coords + (m, ...) inf flags."""
    m = pt[0].shape[0]
    assert m & (m - 1) == 0, "_tree_sum requires power-of-two length"
    while m > 1:
        pt = add(
            tuple(a[0::2] for a in pt), tuple(a[1::2] for a in pt)
        )
        m //= 2
    return pt


def _weighted_bucket_sum(bufs, nb: int, add=point_add):
    """sum_{d>=1} d * B_d  =  sum_{t>=1} S_t  with  S_t = sum_{d>=t} B_d.

    The suffix prefix-sums S over buckets nb-1..1 run as chunked serial
    scans (work-efficient: ~3*nb point adds total, vs nb*log2(nb) twice
    for scan-based suffixing): an inclusive lax.scan across C columns at
    width R (rows = chunks of the reversed bucket order), an exclusive
    width-1 scan over the R row totals, then one wide add to combine and
    a pairwise tree for the final total."""
    import jax
    import jax.numpy as jnp

    bx, by, bz, binf = bufs
    rev = (bx[:0:-1], by[:0:-1], bz[:0:-1], binf[:0:-1])  # buckets nb-1..1
    L = nb - 1
    bits = max(2, (L - 1).bit_length())
    cb = (bits + 1) // 2
    C = 1 << cb
    R = 1 << (bits - cb)
    pad = R * C - L

    def padded(x, fill):
        f = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, f], axis=0)

    arr = (
        padded(rev[0], 0), padded(rev[1], 0), padded(rev[2], 0),
        padded(rev[3], True),
    )
    # flattened index i = r*C + c; scan over columns at width R
    cols = tuple(
        jnp.moveaxis(x.reshape((R, C) + x.shape[1:]), 1, 0) for x in arr
    )

    def step(acc, col):
        acc = add(acc, col)
        return acc, acc

    # identity carries derived from the data (not fresh constants) so the
    # varying-manual-axis tag survives under shard_map
    def inf_like(pt):
        return (pt[0] * 0, pt[1] * 0, pt[2] * 0, pt[3] | True)

    _, P = jax.lax.scan(step, inf_like(tuple(c[0] for c in cols)), cols)
    rowtot = tuple(t[-1] for t in P)  # P: (C, R, ...)

    def step2(acc, row):
        return add(acc, row), acc

    rows = tuple(t[:, None] for t in rowtot)  # (R, 1, ...)
    _, offs = jax.lax.scan(
        step2, inf_like(tuple(r[0] for r in rows)), rows
    )  # exclusive
    # combine in (R, C, ...) form
    offs_rc = tuple(
        jnp.broadcast_to(t, (R, C) + t.shape[2:]) for t in offs
    )
    P_rc = tuple(jnp.moveaxis(t, 0, 1) for t in P)
    S = add(offs_rc, P_rc)
    live = (jnp.arange(R * C) < L).reshape(R, C)
    S = (S[0], S[1], S[2], S[3] | ~live)
    tot = _tree_sum(S, add)  # (1, C, ...)
    tot = _tree_sum(tuple(t[0] for t in tot), add)  # (1, ...)
    return tuple(t[0] for t in tot)


def _window_buckets(digits, X, Y, Z, inf, nb: int):
    """Dense bucket sums of one window: sort the points by digit, then
    the merge-tree reduction -> (nb, NL)-coord bucket buffers."""
    import jax.numpy as jnp

    order = jnp.argsort(digits)
    d = digits[order]
    pt = (X[order], Y[order], Z[order], inf[order] | (d == 0))
    return _bucket_reduce(pt, d, nb)


def _horner_fold(wsums, nw: int, window: int):
    """sum_w 2^(window*w) * wsums[w], high window first, over leading
    axis nw.  One point_double and one point_add in the graph (scan and
    fori_loop), not nw * window unrolled copies."""
    import jax

    total0 = tuple(x[nw - 1] for x in wsums)
    rest = tuple(x[nw - 2 :: -1] for x in wsums)

    def fold(total, nxt):
        total = jax.lax.fori_loop(
            0, window, lambda _, p: point_double(p), total
        )
        return point_add(total, nxt), None

    total, _ = jax.lax.scan(fold, total0, rest)
    return total


def _to_jacobian(Xs, Ys):
    """Standard-form canonical limbs -> Montgomery-domain Jacobian
    coordinates (Z = 1), on device."""
    import jax.numpy as jnp

    X = fq.to_mont(Xs)
    Y = fq.to_mont(Ys)
    return X, Y, jnp.broadcast_to(jnp.asarray(_Z_ONE), X.shape)


@functools.lru_cache(maxsize=None)
def _msm_jit(n: int, window: int = WINDOW):
    import jax

    nb = 1 << window
    nw = (255 + window - 1) // window

    def msm(digits_all, Xs, Ys, inf):
        X, Y, Z = _to_jacobian(Xs, Ys)

        def one_window(carry, digits):
            bufs = _window_buckets(digits, X, Y, Z, inf, nb)
            wsum = _weighted_bucket_sum(bufs, nb)
            return carry, tuple(t[None] for t in wsum)

        _, wsums = jax.lax.scan(one_window, 0, digits_all)
        # wsums leaves: (nw, 1, ...), window w ascending
        return tuple(t[0] for t in _horner_fold(wsums, nw, window))

    return jax.jit(msm)


@functools.lru_cache(maxsize=None)
def _msm_multi_jit(n: int, K: int, window: int = WINDOW):
    """K MSMs over ONE point set (the batched Groth16 prove shape): the
    per-window sort/reduce pipeline vmapped over the K digit rows, with
    the point tensors uploaded and Montgomery-converted once.  Device
    memory grows with K * n."""
    import jax

    nb = 1 << window
    nw = (255 + window - 1) // window

    def msm_multi(digits_all, Xs, Ys, inf):
        # digits_all: (nw, K, n)
        X, Y, Z = _to_jacobian(Xs, Ys)

        def one_window_k(digits):
            bufs = _window_buckets(digits, X, Y, Z, inf, nb)
            return _weighted_bucket_sum(bufs, nb)

        def one_window(carry, digits_w):  # digits_w: (K, n)
            return carry, jax.vmap(one_window_k)(digits_w)

        _, wsums = jax.lax.scan(one_window, 0, digits_all)
        # wsums leaves: (nw, K, ...); the Horner fold broadcasts over K
        return _horner_fold(wsums, nw, window)

    return jax.jit(msm_multi)


def _scalar_rows(scalars) -> np.ndarray:
    from .points import ints_to_limbs

    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint64:
        return np.ascontiguousarray(scalars)
    return ints_to_limbs([int(s) % FR_R for s in scalars], 4)


def g1_msm_tpu_multi(points, scalars_multi, window: int | None = None):
    """K MSMs over one G1Array; returns a list of K affine points / None.
    Same CRS points, (K, n) scalar matrix: the prove_batch shape."""
    import jax.numpy as jnp

    from .points import G1Array

    if window is None:
        window = WINDOW
    assert isinstance(points, G1Array)
    n = len(points)
    n_pad = max(8, 1 << (n - 1).bit_length())
    rows = [_scalar_rows(sc) for sc in scalars_multi]
    K = len(rows)
    digits = np.stack(
        [_window_digits(r, window) for r in rows], axis=1
    )  # (nw, K, n)
    if n_pad > n:
        digits = np.concatenate(
            [digits, np.zeros(digits.shape[:2] + (n_pad - n,), np.int32)],
            axis=2,
        )
    Xs, Ys, inf = _points_std_limbs(points, n_pad)
    ox, oy, oz, oinf = (
        np.asarray(t)
        for t in _msm_multi_jit(n_pad, K, window)(
            jnp.asarray(digits), Xs, Ys, inf
        )
    )
    return [
        None if bool(oinf[k]) else _jac_mont_to_affine(ox[k], oy[k], oz[k])
        for k in range(K)
    ]


LIMB12 = 12
# (NL,) int32 limbs of 1 in the Montgomery domain (Jacobian Z of an
# affine input)
_Z_ONE = fq.int_to_limbs([fq.R_MONT % Q381])[0]


def _u64_rows_to_limb12(rows: np.ndarray, nl: int = None) -> np.ndarray:
    """(n, k) u64 little-endian -> (n, nl) int32 12-bit limbs.

    Pure vectorized bit-slicing — no Python bigints; with the on-device
    `to_mont`, this is the entire host cost of point preparation."""
    if nl is None:
        nl = fq.NL
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    n, k = rows.shape
    out = np.zeros((n, nl), dtype=np.int32)
    for l in range(nl):
        bit = LIMB12 * l
        i, r = divmod(bit, 64)
        if i >= k:
            break
        v = rows[:, i] >> np.uint64(r)
        if r + LIMB12 > 64 and i + 1 < k:
            v = v | (rows[:, i + 1] << np.uint64(64 - r))
        out[:, l] = (v & np.uint64((1 << LIMB12) - 1)).astype(np.int32)
    return out


def _window_digits(scalars_u64: np.ndarray, window: int = WINDOW) -> np.ndarray:
    """(n, 4) u64 -> (nw, n) int32 window digits (host side, vectorized)."""
    sc = np.ascontiguousarray(scalars_u64, dtype=np.uint64)
    nw = (255 + window - 1) // window
    out = np.zeros((nw, sc.shape[0]), dtype=np.int32)
    mask = np.uint64((1 << window) - 1)
    for w in range(nw):
        bit = w * window
        i, r = divmod(bit, 64)
        if i >= sc.shape[1]:
            break
        v = sc[:, i] >> np.uint64(r)
        if r + window > 64 and i + 1 < sc.shape[1]:
            v = v | (sc[:, i + 1] << np.uint64(64 - r))
        out[w] = (v & mask).astype(np.int32)
    return out


def g1_msm_tpu(points, scalars, window: int | None = None):
    """MSM over a points.G1Array; returns an affine point or None.
    Differentially tested against the native C backend.  `window` trades
    bucket-scan length (2^w) for window count (255/w); None uses the
    module default (12) — tests pass small windows to keep CPU runtime
    sane."""
    import jax.numpy as jnp

    from .points import G1Array

    if window is None:
        window = WINDOW
    assert isinstance(points, G1Array)
    n = len(points)
    # pad to the next power of two (infinity points, zero scalars): one
    # compiled graph serves every MSM size in a bucket, and the prover's
    # four different query lengths typically share one compile
    n_pad = max(8, 1 << (n - 1).bit_length())
    digits = _window_digits(_scalar_rows(scalars), window)
    if n_pad > n:
        digits = np.concatenate(
            [digits, np.zeros((digits.shape[0], n_pad - n), np.int32)], axis=1
        )
    Xs, Ys, inf = _points_std_limbs(points, n_pad)
    ox, oy, oz, oinf = (
        np.asarray(t)
        for t in _msm_jit(n_pad, window)(jnp.asarray(digits), Xs, Ys, inf)
    )
    if bool(oinf):
        return None
    return _jac_mont_to_affine(ox, oy, oz)


def _points_std_limbs(points, n_pad: int):
    """G1Array -> device 12-bit-limb standard-form coordinate tensors +
    infinity flags, padded to n_pad with identities.  Cached on the array
    object (a dict keyed by n_pad, so alternating paddings don't thrash):
    the prover reuses the same CRS queries for every proof, so the
    (vectorized, but O(n)) host bit-slicing runs once per key.

    Assumes the G1Array is IMMUTABLE after first use here (G1Array never
    mutates xs/ys/inf in place anywhere in this package); if a caller ever
    rewrites those arrays it must drop `_device_limb_cache` itself."""
    import jax.numpy as jnp

    cache = getattr(points, "_device_limb_cache", None)
    if cache is not None and n_pad in cache:
        return cache[n_pad]
    n = len(points)
    xs = _u64_rows_to_limb12(points.xs)
    ys = _u64_rows_to_limb12(points.ys)
    pad = np.zeros((n_pad - n, fq.NL), np.int32)
    Xs = jnp.asarray(np.concatenate([xs, pad], axis=0))
    Ys = jnp.asarray(np.concatenate([ys, pad], axis=0))
    inf = jnp.asarray(
        np.concatenate([points.inf.astype(bool), np.ones(n_pad - n, bool)])
    )
    out = (Xs, Ys, inf)
    try:
        if cache is None:
            cache = points._device_limb_cache = {}
        cache[n_pad] = out
    except AttributeError:
        pass
    return out


def _jac_mont_to_affine(ox, oy, oz):
    """Montgomery-limb Jacobian -> standard affine ints (host side)."""
    rinv = pow(fq.R_MONT, -1, Q381)
    xi = fq.limbs_to_int(ox) * rinv % Q381
    yi = fq.limbs_to_int(oy) * rinv % Q381
    zi = fq.limbs_to_int(oz) * rinv % Q381
    zinv = pow(zi, -1, Q381)
    zi2 = zinv * zinv % Q381
    return (xi * zi2 % Q381, yi * zi2 % Q381 * zinv % Q381)


def g1_msm_tpu_sharded(points, scalars, window: int | None = None,
                       devices=None):
    """Point-axis data-parallel MSM over a device mesh.

    Each device runs the full Pippenger core (`_msm_jit`) on its local
    slice of the (padded) point/scalar arrays under shard_map — no
    cross-device communication until the D per-shard partial sums, which
    are folded on the host with the pure-Python group law.  Validated
    sharded-vs-single on an 8-device virtual mesh
    (tests/test_tpu_msm.py::test_msm_sharded_matches_single).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    from .bls12_381 import g1_add, g1_from_affine, g1_to_affine
    from .points import G1Array

    if window is None:
        window = WINDOW
    assert isinstance(points, G1Array)
    if devices is None:
        devices = jax.devices()
    D = len(devices)
    n = len(points)
    nw = (255 + window - 1) // window
    # pad so every shard is a power of two >= 8
    per = max(8, 1 << ((n + D - 1) // D - 1).bit_length())
    n_pad = per * D
    digits = _window_digits(_scalar_rows(scalars), window)
    digits = np.concatenate(
        [digits, np.zeros((nw, n_pad - n), np.int32)], axis=1
    )
    Xs, Ys, inf = _points_std_limbs(points, n_pad)

    mesh = Mesh(np.asarray(devices), ("pts",))
    core = _msm_jit(per, window)

    def shard_body(dg, x, y, nf):
        px, py, pz, pinf = core(dg, x, y, nf)
        return px[None], py[None], pz[None], pinf[None]

    sharded = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(None, "pts"), P("pts"), P("pts"), P("pts")),
        out_specs=(P("pts"), P("pts"), P("pts"), P("pts")),
    )
    pX, pY, pZ, pI = (
        np.asarray(t) for t in sharded(jnp.asarray(digits), Xs, Ys, inf)
    )
    acc = None
    for d in range(D):
        if bool(pI[d]):
            continue
        aff = _jac_mont_to_affine(pX[d], pY[d], pZ[d])
        acc = g1_add(acc, g1_from_affine(aff))
    return g1_to_affine(acc) if acc is not None else None
