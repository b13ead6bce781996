"""Device-mesh construction and sharded witness generation.

The reference has NO distributed machinery (SURVEY.md section 2.4: its only
concurrency is rayon inside arkworks).  This module is the device
parallelism stack that replaces it:

  DP  ("batch" axis): signatures sharded across devices -- the realization
      of the reference's empty `falcon-aggregate-sig` stub
      (`/root/reference/falcon-aggregate-sig/src/main.rs:1-3`).
  SP  ("coeff" axis): the NTT-stage/coefficient axis sharded across devices
      (the sequence-parallel analog); early butterfly stages exchange
      coefficients across shards -- XLA inserts the all-to-all/ppermute
      collectives from the shardings.
  TP/PP/EP: not applicable to this workload, with reasons rather than
      silence.  TP over weights: there are no weight matrices.  TP over
      the LIMB axis (SURVEY 2.4's other candidate): structurally wrong
      here — the limb axis is 11-12 rows of 16-bit carries whose
      semi-normalization rounds propagate carry_k -> limb_{k+1}
      sequentially, so a limb-sharded kernel would insert a collective
      inside EVERY carry round of every butterfly stage to move 4-byte
      carries, while one signature's whole limb state (44 KB) fits in a
      thread block's shared memory.  The coeff ("SP") axis gives the same
      intra-signature scaling with one exchange per early NTT stage
      instead.  PP: built and measured 7.7x slower than DP at equal
      devices (parallel/pipeline_pp.py, PARITY_NOTES.md).  EP: no
      experts.

XLA hands the collectives to NCCL, which runs them over NVLink between the
cards of a host (every card reaches every other at the same rate, so the
mesh shape follows the algorithm alone); multi-host extends the same mesh
via jax.distributed (no custom transport, by design).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import get_params
from ..witness.engine import generate_witness_ntt


def make_mesh(n_devices: int | None = None, batch_axis: int | None = None):
    """Build a (batch, coeff) mesh over the available devices.

    batch_axis: number of devices on the data-parallel axis (defaults to all
    devices, coeff axis 1).  The coeff axis shards the polynomial
    coefficient dimension.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if batch_axis is None:
        batch_axis = n
    if n % batch_axis:
        raise ValueError(f"{n} devices not divisible by batch axis {batch_axis}")
    arr = np.asarray(devs).reshape(batch_axis, n // batch_axis)
    return Mesh(arr, ("batch", "coeff"))


@functools.lru_cache(maxsize=None)
def sharded_engine(n: int, mesh_key=None):
    """jit-compiled witness engine with batch-DP + coeff-SP shardings.

    mesh_key: the Mesh (hashable) to place shardings on; None = single
    device jit.

    Implementation is shard_map (not GSPMD sharding hints):
      coeff axis == 1: each device runs the FULL local engine on its batch
        shard — including the platform's hint-NTT kernel (ops/backend.py;
        the kernel call sits inside shard_map and never needs
        partitioning);
      coeff axis > 1: the sequence-parallel local engine — hint NTTs use
        the explicit log2(D)-ppermute schedule of
        parallel/ntt_sharded.ntt_with_hints_local, the inverse NTT gathers
        the (small, int32) product once, and the norm reduction is a psum.
    Outputs are bit-equal to the single-device engine in both modes
    (tests/test_parallel.py).
    """
    from jax import shard_map

    from ..ops.backend import configured_ntt_backend
    from ..witness.engine import _seg_dict

    params = get_params(n)
    mesh = mesh_key
    backend = configured_ntt_backend()

    def local_full(sig, pk_ntt, hm_ntt):
        wb = generate_witness_ntt(sig, pk_ntt, hm_ntt, params, backend)
        return _seg_dict(wb)

    if mesh is None:
        return jax.jit(local_full)

    d_coeff = mesh.shape["coeff"]
    if d_coeff == 1:

        out_specs = {
            "sig": P("batch", None), "v": P("batch", None),
            "range_v": P("batch", None, None),
            "sig_ntt_t": P(None, "batch", None),
            "sig_ntt_b": P("batch", None),
            "sig_ntt_tail": P("batch", None, None),
            "v_ntt_t": P(None, "batch", None),
            "v_ntt_b": P("batch", None),
            "v_ntt_tail": P("batch", None, None),
            "pointwise": P("batch", None, None),
            "pointwise_tail": P("batch", None, None),
            "norm_bits": P(None, "batch", None),
            "norm_vals": P(None, "batch", None),
            "bound": P("batch", None),
            "pk_ntt": P("batch", None), "hm_ntt": P("batch", None),
        }
        fn = shard_map(
            local_full,
            mesh=mesh,
            in_specs=(P("batch", None),) * 3,
            out_specs=out_specs,
        )
        return jax.jit(fn)

    # --- coeff-sharded (sequence-parallel) local engine -------------------
    local_sp = _make_local_sp_engine(params, d_coeff)
    out_specs = {
        "sig": P("batch", "coeff"), "v": P("batch", "coeff"),
        "range_v": P("batch", "coeff", None),
        "sig_ntt_t": P(None, "batch", "coeff"),
        "sig_ntt_b": P("batch", "coeff"),
        "sig_ntt_tail": P("batch", "coeff", None),
        "v_ntt_t": P(None, "batch", "coeff"),
        "v_ntt_b": P("batch", "coeff"),
        "v_ntt_tail": P("batch", "coeff", None),
        "pointwise": P("batch", "coeff", None),
        "pointwise_tail": P("batch", "coeff", None),
        "norm_bits_v": P(None, "batch", "coeff"),
        "norm_bits_sig": P(None, "batch", "coeff"),
        "norm_vals_v": P(None, "batch", "coeff"),
        "norm_vals_sig": P(None, "batch", "coeff"),
        "bound": P("batch", None),
        "pk_ntt": P("batch", "coeff"), "hm_ntt": P("batch", "coeff"),
    }
    sm = shard_map(
        local_sp,
        mesh=mesh,
        in_specs=(P("batch", "coeff"),) * 3,
        out_specs=out_specs,
    )

    @jax.jit
    def run_sp(sig, pk_ntt, hm_ntt):
        seg = dict(sm(sig, pk_ntt, hm_ntt))
        # the norm segment's global layout is [v-block | sig-block]; glue
        # the two coeff-sharded halves in that order
        import jax.numpy as jnp

        seg["norm_bits"] = jnp.concatenate(
            [seg.pop("norm_bits_v"), seg.pop("norm_bits_sig")], axis=2
        )
        seg["norm_vals"] = jnp.concatenate(
            [seg.pop("norm_vals_v"), seg.pop("norm_vals_sig")], axis=2
        )
        return seg

    return run_sp


def _make_local_sp_engine(params, d_coeff: int):
    """Shard-local (per-device) witness engine body for coeff-sharded
    meshes; bit-equal to witness/engine.generate_witness_ntt."""
    import jax.numpy as jnp

    from ..falcon.ntt import intt_jax
    from ..ops.modq import divmod_q as fast_divmod_q, mul_mod_q, sub_mod_q
    from ..witness.engine import (
        _bits,
        _bound_block_512,
        _bound_block_1024,
        _lt_q_chain,
        _norm_block_t,
    )
    from .ntt_sharded import ntt_with_hints_local

    n = params.n
    w = n // d_coeff

    def local_sp(sig, pk_ntt, hm_ntt):
        r = jax.lax.axis_index("coeff")
        sig = sig.astype(jnp.int32)
        pk_ntt = pk_ntt.astype(jnp.int32)
        hm_ntt = hm_ntt.astype(jnp.int32)

        sig_t, sig_b = ntt_with_hints_local(sig, "coeff", params, d_coeff)

        # v = intt(hm - sig_ntt * pk): the int32 product is gathered once
        # (n * 4 bytes/signature) and the inverse NTT runs locally — the
        # expensive limbed forward NTTs above stay fully sharded
        prod_local = sub_mod_q(hm_ntt, mul_mod_q(sig_b, pk_ntt))
        prod_full = jax.lax.all_gather(
            prod_local, "coeff", axis=1, tiled=True
        )
        v_full = intt_jax(prod_full, n)
        v = jax.lax.dynamic_slice_in_dim(v_full, r * w, w, axis=1)

        v_bits = _bits(v, 14)
        range_v = jnp.concatenate([v_bits, _lt_q_chain(v_bits, v)], axis=-1)

        v_t, v_b = ntt_with_hints_local(v, "coeff", params, d_coeff)

        sig_bits = _bits(sig_b, 14)
        v_bits_n = _bits(v_b, 14)
        sig_tail = jnp.concatenate(
            [sig_bits, _lt_q_chain(sig_bits, sig_b)], axis=-1
        )
        v_tail = jnp.concatenate([v_bits_n, _lt_q_chain(v_bits_n, v_b)], axis=-1)

        prod = sig_b * pk_ntt
        tot = v_b + prod
        t_pw, c_pw = fast_divmod_q(tot)
        pw_bits = _bits(c_pw, 14)
        pointwise = jnp.stack([prod, t_pw, c_pw], axis=-1)
        pointwise_tail = jnp.concatenate(
            [pw_bits, _lt_q_chain(pw_bits, c_pw)], axis=-1
        )

        nbits_v, sel_v, sq_v = _norm_block_t(v)
        nbits_s, sel_s, sq_s = _norm_block_t(sig)
        sq = jnp.concatenate([sq_v, sq_s], axis=-1)
        sum_lo = jax.lax.psum(
            jnp.sum(jnp.bitwise_and(sq, 0xFFFF), axis=-1), "coeff"
        )
        sum_hi = jax.lax.psum(jnp.sum(sq >> 16, axis=-1), "coeff")
        norm_lo = jnp.bitwise_and(sum_lo, 0xFFFF)
        norm_hi = sum_hi + (sum_lo >> 16)
        if n == 512:
            bound = _bound_block_512(norm_lo, norm_hi)
        else:
            bound = _bound_block_1024(norm_lo, norm_hi)

        return {
            "sig": sig, "v": v, "range_v": range_v,
            "sig_ntt_t": sig_t, "sig_ntt_b": sig_b,
            "sig_ntt_tail": sig_tail,
            "v_ntt_t": v_t, "v_ntt_b": v_b, "v_ntt_tail": v_tail,
            "pointwise": pointwise, "pointwise_tail": pointwise_tail,
            "norm_bits_v": nbits_v, "norm_bits_sig": nbits_s,
            "norm_vals_v": jnp.stack([sel_v, sq_v], axis=0),
            "norm_vals_sig": jnp.stack([sel_s, sq_s], axis=0),
            "bound": bound,
            "pk_ntt": pk_ntt, "hm_ntt": hm_ntt,
        }

    return local_sp


_DUAL_LIMB_KEYS = frozenset(
    {"sp_t", "sn_t", "vp_t", "vn_t", "pointwise_vals"}
)


@functools.lru_cache(maxsize=None)
def sharded_engine_dual(n: int, mesh_key):
    """Batch-DP sharded dual-NTT witness engine (shard_map; the
    platform's hint-NTT kernel runs inside each shard)."""
    from jax import shard_map

    from ..ops.backend import configured_ntt_backend
    from ..witness.engine_dual import generate_witness_dual

    params = get_params(n)
    mesh = mesh_key
    backend = configured_ntt_backend()

    def local(sig, pk_ntt, hm_ntt):
        return generate_witness_dual(sig, pk_ntt, hm_ntt, params, backend)

    shapes = jax.eval_shape(
        local,
        jax.ShapeDtypeStruct((1, n), np.int32),
        jax.ShapeDtypeStruct((1, n), np.int32),
        jax.ShapeDtypeStruct((1, n), np.int32),
    )
    out_specs = {
        k: P(None, "batch") if k in _DUAL_LIMB_KEYS else P("batch")
        for k in shapes
    }
    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P("batch", None),) * 3,
            out_specs=out_specs,
        )
    )


@functools.lru_cache(maxsize=None)
def sharded_engine_schoolbook(n: int, mesh_key):
    """Batch-DP sharded schoolbook witness engine (shard_map)."""
    from jax import shard_map

    from ..witness.engine_schoolbook import generate_witness_schoolbook

    params = get_params(n)
    mesh = mesh_key

    def local(sig, pk, hm):
        return generate_witness_schoolbook(sig, pk, hm, params)

    shapes = jax.eval_shape(
        local,
        jax.ShapeDtypeStruct((1, n), np.int32),
        jax.ShapeDtypeStruct((1, n), np.int32),
        jax.ShapeDtypeStruct((1, n), np.int32),
    )
    out_specs = {k: P("batch") for k in shapes}
    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P("batch", None),) * 3,
            out_specs=out_specs,
        )
    )


def place_batch(mesh, sig, pk_ntt, hm_ntt):
    """Device-put a host batch with (batch, coeff) sharding."""
    sh = NamedSharding(mesh, P("batch", "coeff"))
    return (
        jax.device_put(sig, sh),
        jax.device_put(pk_ntt, sh),
        jax.device_put(hm_ntt, sh),
    )
