"""End-to-end batched proving-input pipeline: the framework's runtime.

Wire-format (pk, msg, sig) triples in; per-signature R1CS witness +
public-input tensors out.  Stages:

  1. decode pk/sig bytes (host; falcon/codec.py)
  2. hash-to-point for the whole batch (host, native C via OpenMP --
     falcon/hash_to_point.py; the one inherently sequential stage)
  3. clear NTTs of pk and hm (device)
  4. batched witness generation (device; witness/engine.py)
  5. optional canonical (B, W, 5)-u32 packing (device;
     witness/export_device.py) and satisfiability check (parallel/sat_check)

This is the realization of the reference's empty `falcon-aggregate-sig`
batch-verification stub (`/root/reference/falcon-aggregate-sig/src/main.rs:1-3`)
as a production data path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .falcon import (
    decode_public_key,
    decompress_signature,
    hash_to_point_batch,
)
from .falcon.ntt import ntt_jax
from .params import FalconParams, Q
from .witness.engine import jitted_engine
from .witness.export_device import packer_ntt


@dataclass
class ProverInputs:
    """Device-resident outputs for a batch."""

    seg: dict                 # engine segment tensors
    pk_ntt: np.ndarray        # (B, n) public inputs
    hm_ntt: np.ndarray        # (B, n) public inputs
    packed: np.ndarray | None  # (B, W, 5) canonical witness limbs


class ProverInputPipeline:
    def __init__(
        self,
        params: FalconParams,
        pack: bool = True,
        max_chunk: int = 2048,
    ):
        """max_chunk bounds device memory: a Falcon-1024 signature's full
        witness is ~700 KB of segments, so batches are processed in
        sub-batches of at most `max_chunk` and re-stitched on host when a
        larger batch is supplied."""
        self.params = params
        self.pack = pack
        self.max_chunk = max_chunk
        self.codec: str | None = None
        self._engine = jitted_engine(params.n)
        self._packer = packer_ntt(params.n) if pack else None

    def _run_chunk(self, sig, pk_ntt, hm_ntt) -> ProverInputs:
        seg = self._engine(sig, pk_ntt, hm_ntt)
        packed = self._packer(seg) if self._packer else None
        return ProverInputs(
            seg=seg, pk_ntt=seg["pk_ntt"], hm_ntt=seg["hm_ntt"],
            packed=packed,
        )

    def run_decoded(self, sig_signed, h, msgs, nonces) -> ProverInputs:
        """From decoded arrays: sig_signed (B, n) ints, h (B, n) in [0, q),
        msgs list[bytes], nonces list[bytes].

        All device inputs are < q = 12289 < 2^14, so they ship as int16 —
        half the host->device bytes of the int32 planes; ntt_jax and the
        engine cast to int32 at trace entry."""
        import jax.numpy as jnp

        n = self.params.n
        hm = hash_to_point_batch(msgs, nonces, n)          # host, native C
        sig = (np.asarray(sig_signed) % Q).astype(np.int16)
        h_dev = jnp.asarray(np.asarray(h), dtype=jnp.int16)
        hm_dev = jnp.asarray(np.asarray(hm), dtype=jnp.int16)
        pk_ntt = ntt_jax(h_dev, n)
        hm_ntt = ntt_jax(hm_dev, n)
        B = sig.shape[0]
        if B <= self.max_chunk:
            return self._run_chunk(sig, pk_ntt, hm_ntt)
        outs = [
            self._run_chunk(
                sig[i : i + self.max_chunk],
                pk_ntt[i : i + self.max_chunk],
                hm_ntt[i : i + self.max_chunk],
            )
            for i in range(0, B, self.max_chunk)
        ]
        # batch axis is 1 for feature-first segments (NTT hint limbs and
        # the norm blocks), 0 everywhere else
        seg = {
            k: np.concatenate(
                [np.asarray(o.seg[k]) for o in outs],
                axis=1
                if k.endswith("_t")
                or k in ("norm_bits", "norm_vals", "pointwise_vals")
                else 0,
            )
            for k in outs[0].seg
        }
        packed = (
            np.concatenate([np.asarray(o.packed) for o in outs], axis=0)
            if self.pack
            else None
        )
        return ProverInputs(
            seg=seg, pk_ntt=seg["pk_ntt"], hm_ntt=seg["hm_ntt"],
            packed=packed,
        )

    def run_wire(self, pk_bytes_list, msgs, sig_bytes_list) -> ProverInputs:
        """From raw wire bytes (the full falcon-aggregate-sig path).

        Uses the native C batch codecs (OpenMP) when the library builds,
        the pure-Python codec otherwise; `self.codec` records which one
        ("native" or "python") the last call ran."""
        hp, hs_ = self.params.header_pk, self.params.header_sig
        for pkb, sgb in zip(pk_bytes_list, sig_bytes_list):
            if not pkb or pkb[0] != hp or len(pkb) != self.params.pk_bytes:
                raise ValueError("parameter-set mismatch in batch")
            if not sgb or sgb[0] != hs_ or len(sgb) != self.params.sig_bytes:
                raise ValueError("parameter-set mismatch in batch")
        try:
            from .native import (
                native_decode_pk_batch,
                native_decode_sig_batch,
            )

            hs = native_decode_pk_batch(list(pk_bytes_list), self.params.n)
            sigs, nonces = native_decode_sig_batch(
                list(sig_bytes_list), self.params.n
            )
            self.codec = "native"
        except (ImportError, OSError, RuntimeError):
            self.codec = "python"
            sigs, nonces, hs = [], [], []
            for pkb, sgb in zip(pk_bytes_list, sig_bytes_list):
                h, _ = decode_public_key(pkb)
                s2, nonce, _ = decompress_signature(sgb)
                hs.append(h)
                sigs.append(s2)
                nonces.append(nonce)
            hs = np.stack(hs)
            sigs = np.stack(sigs)
        return self.run_decoded(
            np.asarray(sigs), np.asarray(hs), list(msgs), nonces
        )
