"""Native host-side primitives: ctypes bindings for falcon_native.c.

Built on first use by gcc into the gitignored build directory (see
native/build.py); no pybind11 needed.  A failed build raises
RuntimeError, which the pipeline's codec treats as "no native library"
and answers with the pure-Python codec.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "falcon_native.c"

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from .build import build_library

    common = ["gcc", "-O3", "-shared", "-fPIC"]
    so = build_library(
        "falcon_native",
        [_SRC],
        # the portable build is the fallback where OpenMP is missing
        [common + ["-march=native", "-fopenmp", str(_SRC)],
         common + [str(_SRC)]],
    )
    lib = ctypes.CDLL(str(so))
    lib.hash_to_point_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
        ctypes.c_long,
    ]
    lib.shake256.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    for fn in (lib.decode_pk_batch, lib.decode_sig_batch):
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
            ctypes.c_long,
        ]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def native_shake256(data: bytes, out_len: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(out_len)
    lib.shake256(data, len(data), out, out_len)
    return out.raw


def native_hash_to_point_batch(msgs, nonces, n: int) -> np.ndarray:
    """Batched hash-to-point -> (batch, n) int64, bit-exact with the
    pure-Python hashlib path."""
    lib = _load()
    batch = len(msgs)
    blob = b"".join(msgs)
    offsets = np.zeros(batch + 1, dtype=np.int64)
    np.cumsum([len(m) for m in msgs], out=offsets[1:])
    nonce_len = len(nonces[0])
    for nc in nonces:
        if len(nc) != nonce_len:
            raise ValueError("all nonces must have equal length")
    nblob = b"".join(nonces)
    out = np.empty((batch, n), dtype=np.int32)
    lib.hash_to_point_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nblob,
        nonce_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        batch,
        n,
    )
    return out.astype(np.int64)


def native_decode_pk_batch(pk_bytes_list, n: int) -> np.ndarray:
    """Batched public-key decode (bodies after the header byte) -> (B, n)
    int32 coefficients.  Raises ValueError on any malformed key."""
    lib = _load()
    stride = len(pk_bytes_list[0]) - 1
    if any(len(pkb) != stride + 1 for pkb in pk_bytes_list):
        raise ValueError("mixed public-key lengths in batch")
    bodies = b"".join(pkb[1:] for pkb in pk_bytes_list)
    out = np.empty((len(pk_bytes_list), n), dtype=np.int32)
    rc = lib.decode_pk_batch(
        bodies, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(pk_bytes_list), n,
    )
    if rc:
        raise ValueError("malformed public key in batch")
    return out


def native_decode_sig_batch(sig_bytes_list, n: int, nonce_len: int = 40):
    """Batched signature decode -> ((B, n) int32 signed coeffs, list of
    nonces).  Raises ValueError on any malformed signature."""
    lib = _load()
    stride = len(sig_bytes_list[0]) - 1 - nonce_len
    if any(len(s) != stride + 1 + nonce_len for s in sig_bytes_list):
        raise ValueError("mixed signature lengths in batch")
    bodies = b"".join(s[1 + nonce_len:] for s in sig_bytes_list)
    nonces = [s[1:1 + nonce_len] for s in sig_bytes_list]
    out = np.empty((len(sig_bytes_list), n), dtype=np.int32)
    rc = lib.decode_sig_batch(
        bodies, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(sig_bytes_list), n,
    )
    if rc:
        raise ValueError("malformed signature in batch")
    return out, nonces
