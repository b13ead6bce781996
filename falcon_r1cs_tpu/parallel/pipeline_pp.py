"""Pipeline parallelism (PP) over the NTT stage axis — SURVEY §2.4's one
remaining strategy, built as a measured demonstrator.

GPipe-style schedule on a ``stage`` mesh axis of S devices: the log2(n)
butterfly stages of the forward NTT are split into S contiguous groups,
one group per device; T microbatches stream through the pipe.  At
schedule step t (0 <= t < T + S - 1), device s applies its stage group
to microbatch t - s (valid while 0 <= t - s < T) and hands the
activation to device s + 1 with one `lax.ppermute` — the classic
conveyor with an (S - 1)-step fill/drain bubble.

Why this exists: the reference scales with rayon over independent
signatures (SURVEY §2.4), i.e. pure DP; PP is the one row of the
parallelism table with nothing behind it.
This module closes the row with a working, bit-exact implementation AND
the measurement that justifies never promoting it to the production
engine (tools/pp_vs_dp.py, PARITY_NOTES.md "Pipeline parallelism"):

  * DP moves ZERO bytes between devices — witness generation is
    embarrassingly parallel over signatures, and the "weights" (NTT
    twiddle tables, q-power constants) are a few KB, replicated for
    free.  PP moves the full activation (mb x n int32) between devices at
    every stage boundary for every microbatch, and still pays the
    (S - 1)/(T + S - 1) bubble.  PP's real use case — model state too
    large for one chip — cannot arise here.

Layout notes: all S stage groups run as one SPMD program —
`lax.switch` on `axis_index` picks the device's group, so XLA compiles
a single module and the conveyor is a `lax.scan` whose body contains
exactly one collective-permute (asserted from the compiled HLO in
tests/test_pipeline_pp.py).  No host round-trips inside the schedule.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q
from ..params import FalconParams


def _stage_groups(log_n: int, n_stages: int) -> list[tuple[int, int]]:
    """Split butterfly stages 0..log_n-1 into n_stages contiguous
    [start, stop) groups, sizes as equal as possible (front-loaded)."""
    base, extra = divmod(log_n, n_stages)
    groups, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        groups.append((start, start + size))
        start += size
    return groups


def _apply_stages(x, table, n: int, l0: int, l1: int):
    """Butterfly stages [l0, l1) of the iterative forward NTT on a full
    (mb, n) block — the D=1 specialization of ntt_sharded's local path
    (reference semantics: falcon-rust ntt via poly.rs, see
    gadgets/poly.py:72 for the circuit twin)."""
    mb = x.shape[0]
    for l in range(l0, l1):
        m = 1 << l
        half = n >> (l + 1)
        xm = x.reshape(mb, m, 2, half)
        s_tw = jax.lax.dynamic_slice_in_dim(table, m, m).reshape(1, m, 1)
        u = xm[:, :, 0, :]
        v = mul_mod_q(xm[:, :, 1, :], s_tw)
        x = jnp.stack([add_mod_q(u, v), sub_mod_q(u, v)], axis=2).reshape(
            mb, n
        )
    return x


def _build_pp_ntt(mesh: Mesh, params: FalconParams, axis: str,
                  microbatch: int, n_micro: int):
    n, log_n = params.n, params.log_n
    S = int(mesh.shape[axis])
    if S < 2:
        raise ValueError("pipeline needs >= 2 stage devices")
    groups = _stage_groups(log_n, S)
    table = np.asarray(params.ntt_table, dtype=np.int32)
    T = n_micro
    mb = microbatch

    def local_fn(x_all):
        # x_all: (T, mb, n) replicated input (stage-0 feed).  Keeping the
        # feed replicated costs nothing at demo scale and keeps the
        # schedule a pure scan; a production pipe would stagger it.
        s = jax.lax.axis_index(axis)
        tbl = jnp.asarray(table)

        branches = [
            functools.partial(_apply_stages, table=tbl, n=n, l0=l0, l1=l1)
            for (l0, l1) in groups
        ]

        def step(carry, t):
            state, outbuf = carry
            # hand the previous step's activation to the next stage
            recv = jax.lax.ppermute(
                state, axis, [(i, i + 1) for i in range(S - 1)]
            )
            feed_idx = jnp.clip(t, 0, T - 1)
            x0 = jax.lax.dynamic_slice_in_dim(x_all, feed_idx, 1, 0)[0]
            state_in = jnp.where(s == 0, x0, recv)
            out = jax.lax.switch(s, branches, state_in)
            # device S-1 finished microbatch t - (S - 1) this step
            done_idx = jnp.clip(t - (S - 1), 0, T - 1)
            valid = (s == S - 1) & (t >= S - 1)
            updated = jax.lax.dynamic_update_slice_in_dim(
                outbuf, out[None], done_idx, 0
            )
            outbuf = jnp.where(valid, updated, outbuf)
            return (out, outbuf), None

        # initial carries are device-varying (the body mixes in
        # axis_index), so mark them as such for the scan type check
        def _varying(v):
            pcast = getattr(jax.lax, "pcast", None)
            if pcast is not None:
                return pcast(v, axis, to="varying")
            return jax.lax.pvary(v, (axis,))

        zeros = _varying(jnp.zeros((mb, n), jnp.int32))
        outbuf0 = _varying(jnp.zeros((T, mb, n), jnp.int32))
        (_, outbuf), _ = jax.lax.scan(
            step, (zeros, outbuf0), jnp.arange(T + S - 1)
        )
        # only the last stage holds real data; one psum replicates the
        # result (counted as PP overhead in the tools/pp_vs_dp.py model)
        outbuf = jnp.where(s == S - 1, outbuf, jnp.zeros_like(outbuf))
        return jax.lax.psum(outbuf, axis)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(None, None, None),
        out_specs=P(None, None, None),
    )
    return jax.jit(fn)


def pp_ntt(mesh: Mesh, params: FalconParams, axis: str = "stage",
           microbatch: int = 8, n_micro: int = 8):
    """Returns a jitted (T*mb, n) -> (T*mb, n) forward NTT computed by
    the S-stage pipeline schedule above.  Inputs in [0, q); outputs
    bit-equal to the single-device NTT (tests/test_pipeline_pp.py)."""
    inner = _build_pp_ntt(mesh, params, axis, microbatch, n_micro)

    def run(x):
        T, mb = n_micro, microbatch
        if x.shape[0] != T * mb:
            raise ValueError(f"batch {x.shape[0]} != n_micro*microbatch "
                             f"{T * mb}")
        out = inner(x.reshape(T, mb, params.n))
        return out.reshape(T * mb, params.n)

    return run


def dp_ntt(mesh: Mesh, params: FalconParams, axis: str = "stage"):
    """The DP comparator on the SAME mesh axis: batch-shard the NTT, no
    collectives at all (asserted in tests).  This is what the production
    engine does; pp_ntt exists to measure why."""
    n, log_n = params.n, params.log_n
    table = np.asarray(params.ntt_table, dtype=np.int32)

    def local_fn(x):
        return _apply_stages(x, jnp.asarray(table), n, 0, log_n)

    fn = shard_map(
        local_fn, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None)
    )
    return jax.jit(fn)
