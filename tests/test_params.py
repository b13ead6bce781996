"""NTT table ground truth, from first principles.

The tables must equal the Falcon C `vrfy.c` tables (Montgomery form there,
plain form here after division by R = 2^16 mod q).  That C ground truth is
not in this repository, so the tests below check what defines the tables:
psi = 7 is a primitive 2048-th root of unity mod q, entry i of the forward
table is psi_n^bitrev(i), and the inverse table is its entry-wise inverse.
A SHA-256 of each table, taken from the tables that last matched the C
tables, pins them against any change."""

import hashlib

import pytest

from falcon_r1cs_tpu.params import (
    FALCON_512,
    FALCON_1024,
    FIELD_MODULUS,
    PSI_1024,
    Q,
    bitrev,
    get_params,
    inv_ntt_table,
    ntt_table,
)

# sha256 of ",".join(str(v) for v in table)
TABLE_SHA256 = {
    ("forward", 512):
        "2ba6b5ca75194fddb4fae48d673f3d36dc93a42fad6653ff61c4695595bacec5",
    ("forward", 1024):
        "a74f260827b9f9d9825952d0ba9ed092d6beb645e5c14a9858bec84ce3ba6049",
    ("reverse", 512):
        "0b41dd2d825b7f5ef0415c35d98d481c0ac54be719f940f0b01c879dfac09019",
    ("reverse", 1024):
        "6b987a69e01c8aa30c7c218ac4e0f5050ad5c6cc72ed78b73dbe4bb8e7fc5190",
}


def _sha(table):
    return hashlib.sha256(",".join(map(str, table)).encode()).hexdigest()


def test_forward_table_matches_falcon_c():
    """psi is a primitive 2048-th root of unity and table[i] =
    psi^bitrev(i): psi^1024 = -1 (so its order is exactly 2048)."""
    psi = PSI_1024
    assert pow(psi, 2048, Q) == 1
    assert pow(psi, 1024, Q) == Q - 1
    table = ntt_table(1024)
    assert len(table) == 1024
    assert list(table) == [pow(psi, bitrev(i, 10), Q) for i in range(1024)]
    assert _sha(table) == TABLE_SHA256[("forward", 1024)]


def test_reverse_table_matches_falcon_c():
    """Falcon's iGMb table: iGMb[i] = psi^-bitrev(i), the entry-wise
    inverse of the forward table."""
    fwd, inv = ntt_table(1024), inv_ntt_table(1024)
    assert len(inv) == 1024
    assert all(f * g % Q == 1 for f, g in zip(fwd, inv))
    assert _sha(inv) == TABLE_SHA256[("reverse", 1024)]


@pytest.mark.parametrize("n", [512, 1024])
def test_table_digests_pinned(n):
    assert _sha(ntt_table(n)) == TABLE_SHA256[("forward", n)]
    assert _sha(inv_ntt_table(n)) == TABLE_SHA256[("reverse", n)]


def test_512_root_is_psi_squared():
    """Falcon-512's psi is psi_1024^2 = 49, a primitive 1024-th root."""
    psi = pow(PSI_1024, 2, Q)
    assert psi == 49
    assert pow(psi, 512, Q) == Q - 1
    assert list(ntt_table(512)) == [
        pow(psi, bitrev(i, 9), Q) for i in range(512)
    ]


def test_table_512_is_prefix_of_1024():
    assert ntt_table(512) == ntt_table(1024)[:512]


def test_q_structure():
    assert Q == 12289 == (1 << 13) + (1 << 12) + 1
    assert (Q - 1) % 2048 == 0  # primitive 2048th roots exist


def test_params_lookup():
    assert get_params(512) is FALCON_512
    assert get_params(1024) is FALCON_1024
    with pytest.raises(ValueError):
        get_params(256)


def test_const_q_powers():
    p = FALCON_512
    cw = p.const_q_powers
    assert len(cw) == p.log_n + 1
    assert cw[0] == Q
    for x in range(1, p.log_n + 2):
        assert cw[x - 1] == (1 << (x - 1)) * Q**x
    # bound-tracking invariant: max intermediate far below the field modulus
    assert 2**FALCON_1024.log_n * Q ** (FALCON_1024.log_n + 1) < FIELD_MODULUS


def test_sig_l2_bounds():
    # Appendix A item 2: the 1024 bound is 70265242, not the stale 34034726
    assert FALCON_512.sig_l2_bound == 34034726
    assert FALCON_1024.sig_l2_bound == 70265242
    assert FALCON_512.sig_l2_bound == 0b10000001110101010000100110
    assert FALCON_1024.sig_l2_bound == 0b100001100000010100110011010


def test_bitrev():
    assert bitrev(1, 10) == 512
    assert bitrev(0b1100000000, 10) == 0b11
