"""Differential tests for the device G1 MSM (snark/tpu_msm.py) and its
Montgomery limb core (ops/fq_mont.py) against the pure-Python BLS12-381
host implementation.

The MSM test uses a small window (2^4 buckets) so the Hillis-Steele
bucket scans stay CPU-sized; the production window (12) exercises the
identical code path with different static shapes.
"""

import secrets

import numpy as np
import pytest

from falcon_r1cs_tpu.ops import fq_mont as fq
from falcon_r1cs_tpu.snark import bls12_381 as bls
from falcon_r1cs_tpu.snark import tpu_msm
from falcon_r1cs_tpu.snark.points import G1Array


def _rand_fq(n):
    return [secrets.randbelow(bls.P) for _ in range(n)]


def test_mont_mul_matches_int():
    import jax.numpy as jnp

    xs, ys = _rand_fq(16), _rand_fq(16)
    a = jnp.asarray(fq.int_to_limbs([x * fq.R_MONT % bls.P for x in xs]))
    b = jnp.asarray(fq.int_to_limbs([y * fq.R_MONT % bls.P for y in ys]))
    out = np.asarray(fq.mont_mul(a, b))
    for i in range(16):
        want = xs[i] * ys[i] % bls.P * fq.R_MONT % bls.P
        # relaxed representation: representatives are unique only mod q
        assert fq.limbs_to_int(out[i]) % bls.P == want, i


def test_mont_roundtrip_add_sub():
    import jax.numpy as jnp

    xs, ys = _rand_fq(8), _rand_fq(8)
    a = jnp.asarray(fq.int_to_limbs(xs))
    b = jnp.asarray(fq.int_to_limbs(ys))
    back = np.asarray(fq.from_mont(fq.to_mont(a)))
    add = np.asarray(fq.add_mod(a, b))
    sub = np.asarray(fq.sub_mod(a, b))
    for i in range(8):
        # all outputs are relaxed representatives — compare mod q
        assert fq.limbs_to_int(back[i]) % bls.P == xs[i]
        assert fq.limbs_to_int(add[i]) % bls.P == (xs[i] + ys[i]) % bls.P
        assert fq.limbs_to_int(sub[i]) % bls.P == (xs[i] - ys[i]) % bls.P


def _to_jac_limbs(pts):
    """list of (affine | None) -> batched Jacobian mont-limb tensors."""
    import jax.numpy as jnp

    xs = [0 if p is None else p[0] * fq.R_MONT % bls.P for p in pts]
    ys = [0 if p is None else p[1] * fq.R_MONT % bls.P for p in pts]
    X = jnp.asarray(fq.int_to_limbs(xs))
    Y = jnp.asarray(fq.int_to_limbs(ys))
    Z = jnp.asarray(fq.int_to_limbs([fq.R_MONT % bls.P] * len(pts)))
    inf = jnp.asarray(np.asarray([p is None for p in pts]))
    return (X, Y, Z, inf)


def _from_jac_limbs(out, i):
    X, Y, Z, inf = (np.asarray(t) for t in out)
    if bool(inf[i]):
        return None
    rinv = pow(fq.R_MONT, -1, bls.P)
    x = fq.limbs_to_int(X[i]) * rinv % bls.P
    y = fq.limbs_to_int(Y[i]) * rinv % bls.P
    z = fq.limbs_to_int(Z[i]) * rinv % bls.P
    zinv = pow(z, -1, bls.P)
    return (
        x * zinv * zinv % bls.P,
        y * zinv * zinv % bls.P * zinv % bls.P,
    )


def test_point_add_matches_host():
    import jax

    g = bls.G1_GEN
    gen = bls.g1_from_affine(g)
    p2 = bls.g1_to_affine(bls.g1_mul(gen, 7))
    neg_g = (g[0], bls.P - g[1])
    # rows: generic add, tangent (P+P), chord-to-infinity (P + -P),
    # inf + P, P + inf, inf + inf
    lhs = [g, g, g, None, p2, None]
    rhs = [p2, g, neg_g, p2, None, None]
    out = jax.jit(tpu_msm.point_add)(_to_jac_limbs(lhs), _to_jac_limbs(rhs))
    for i, (a, b) in enumerate(zip(lhs, rhs)):
        pa = None if a is None else bls.g1_from_affine(a)
        pb = None if b is None else bls.g1_from_affine(b)
        want = bls.g1_to_affine(bls.g1_add(pa, pb))
        assert _from_jac_limbs(out, i) == want, i


@pytest.mark.slow
def test_msm_small_window_matches_host():
    n = 8
    ks = [secrets.randbelow(1000) + 1 for _ in range(n)]
    scalars = [secrets.randbelow(bls.R) for _ in range(n)]
    scalars[3] = 0  # zero-scalar row
    gen = bls.g1_from_affine(bls.G1_GEN)
    pts = [bls.g1_to_affine(bls.g1_mul(gen, k)) for k in ks]
    pts[5] = None  # infinity row
    arr = G1Array.from_affine_list(pts)
    got = tpu_msm.g1_msm_tpu(arr, scalars, window=4)
    acc = None
    for p, s in zip(pts, scalars):
        if p is None or s == 0:
            continue
        acc = bls.g1_add(acc, bls.g1_mul(bls.g1_from_affine(p), s))
    want = bls.g1_to_affine(acc)
    assert got == want


def test_prove_with_tpu_g1_backend(monkeypatch):
    """Same toxic waste + blinding => bit-identical proof regardless of
    which backend ran the G1 MSMs."""
    from falcon_r1cs_tpu.snark.groth16 import SetupToxic, prove, setup, verify
    from tests.test_snark import _toy_circuit

    monkeypatch.setattr(tpu_msm, "WINDOW", 4)
    compiled, assignment = _toy_circuit()
    tox = SetupToxic(tau=11, alpha=12, beta=13, gamma=14, delta=15)
    pk = setup(compiled, toxic=tox, use_native=False)
    host = prove(pk, compiled, assignment, r=21, s=22, use_native=False)
    dev = prove(
        pk, compiled, assignment, r=21, s=22, use_native=False,
        g1_backend="tpu",
    )
    assert dev == host
    assert verify(pk.vk, [1, 35], dev)


def test_msm_all_zero_is_infinity():
    pts = [bls.G1_GEN] * 4
    arr = G1Array.from_affine_list(pts)
    assert tpu_msm.g1_msm_tpu(arr, [0, 0, 0, 0], window=4) is None


@pytest.mark.slow
def test_msm_multi_matches_single_tpu():
    """K-fold batched MSM (g1_msm_tpu_multi, the prove_batch shape)
    vs per-k g1_msm_tpu: full-width, bits, all-zero (infinity), and
    repeated-scalar vectors over one 8-point set."""
    n = 8
    gen = bls.g1_from_affine(bls.G1_GEN)
    pts = [bls.g1_to_affine(bls.g1_mul(gen, k + 2)) for k in range(n)]
    pts[5] = None
    arr = G1Array.from_affine_list(pts)
    vectors = [
        [secrets.randbelow(bls.R) for _ in range(n)],
        [0] * n,
        [secrets.randbelow(2) for _ in range(n)],
        [7] * n,
    ]
    got = tpu_msm.g1_msm_tpu_multi(arr, vectors, window=4)
    for k, sc in enumerate(vectors):
        assert got[k] == tpu_msm.g1_msm_tpu(arr, sc, window=4), f"k={k}"


@pytest.mark.slow
def test_msm_sharded_matches_single():
    """Point-axis sharded MSM across the 8-device virtual mesh equals the
    single-device result (and the host reduction)."""
    import jax

    n = 40  # deliberately not a multiple of 8: exercises padding
    ks = [secrets.randbelow(500) + 1 for k in range(n)]
    scalars = [secrets.randbelow(bls.R) for _ in range(n)]
    scalars[7] = 0
    gen = bls.g1_from_affine(bls.G1_GEN)
    pts = [bls.g1_to_affine(bls.g1_mul(gen, k)) for k in ks]
    pts[11] = None
    arr = G1Array.from_affine_list(pts)
    single = tpu_msm.g1_msm_tpu(arr, scalars, window=4)
    sharded = tpu_msm.g1_msm_tpu_sharded(
        arr, scalars, window=4, devices=jax.devices()
    )
    assert sharded == single


@pytest.mark.slow
def test_msm_same_digit_runs_match_host():
    """Heavy same-digit runs (long bucket segments through the merge
    tree), a zero scalar and an infinity point, single and K-fold."""
    tpu_msm._msm_jit.cache_clear()
    tpu_msm._msm_multi_jit.cache_clear()
    n = 32
    gen = bls.g1_from_affine(bls.G1_GEN)
    pts = [bls.g1_to_affine(bls.g1_mul(gen, k + 2)) for k in range(n)]
    pts[9] = None
    arr = G1Array.from_affine_list(pts)
    scalars = [secrets.randbelow(16) for _ in range(n)]  # window=4 digits
    scalars[3] = 0
    for i in range(6, 26):
        scalars[i] = 5
    got = tpu_msm.g1_msm_tpu(arr, scalars, window=4)
    acc = None
    for p, s in zip(pts, scalars):
        if p is None or s == 0:
            continue
        acc = bls.g1_add(acc, bls.g1_mul(bls.g1_from_affine(p), s))
    assert got == bls.g1_to_affine(acc)
    vectors = [scalars, [1] * n, [secrets.randbelow(bls.R) for _ in range(n)]]
    multi = tpu_msm.g1_msm_tpu_multi(arr, vectors, window=4)
    for k, sc in enumerate(vectors):
        assert multi[k] == tpu_msm.g1_msm_tpu(arr, sc, window=4), f"k={k}"
