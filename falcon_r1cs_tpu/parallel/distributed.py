"""Multi-host orchestration: jax.distributed init, global meshes, per-host
input sharding, and the scaling-efficiency harness.

The reference is single-process (SURVEY.md section 2.4); this module is the
framework's multi-host layer.  No custom transport exists by design: XLA
hands collectives to NCCL, over NVLink between the GPUs of a host and the
network across hosts once jax.distributed is initialized.  On a single
host everything degrades to the local device set, so the same code paths
are exercised by the CPU-mesh tests and by a real cluster.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import Q


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed from the standard env (JAX_COORDINATOR
    and its process count / id) when running multi-process; no-op on a
    single host.
    Returns True if a multi-process cluster is active.

    The env check comes FIRST: jax.distributed.initialize must run before
    any backend-initializing JAX call (jax.process_count / jax.devices),
    so this function must not touch devices until initialization is
    settled."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        try:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                process_id=int(os.environ["JAX_PROCESS_ID"]),
            )
        except RuntimeError:
            pass  # already initialized (e.g. by the launcher/runtime)
        return True
    return jax.process_count() > 1


def global_mesh(batch_axis: int | None = None) -> Mesh:
    """(batch, coeff) mesh over ALL global devices (all hosts)."""
    devs = jax.devices()
    n = len(devs)
    if batch_axis is None:
        batch_axis = n
    arr = np.asarray(devs).reshape(batch_axis, n // batch_axis)
    return Mesh(arr, ("batch", "coeff"))


def host_local_batch(rng: np.random.Generator, n: int, global_batch: int):
    """This host's slice of a globally batch-sharded synthetic input set.

    Each host materializes only its own rows (per-host I/O of signature
    shards -- SURVEY.md section 2.4 communication-backend row); the arrays
    are then assembled into globally-sharded jax.Arrays with
    make_array_from_process_local_data.
    """
    per_host = global_batch // jax.process_count()
    sig = rng.integers(0, Q, size=(per_host, n), dtype=np.int32)
    pk = rng.integers(0, Q, size=(per_host, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(per_host, n), dtype=np.int32)
    return sig, pk, hm


def make_global_arrays(mesh: Mesh, local_arrays, global_batch: int, n: int):
    """Assemble per-host arrays into globally sharded jax.Arrays."""
    sharding = NamedSharding(mesh, P("batch", "coeff"))
    out = []
    for a in local_arrays:
        out.append(
            jax.make_array_from_process_local_data(
                sharding, a, global_shape=(global_batch, n)
            )
        )
    return tuple(out)


@dataclass
class ScalingPoint:
    devices: int
    witnesses_per_sec: float
    efficiency: float  # vs linear scaling from the smallest point


def scaling_sweep(n: int = 1024, batch_per_device: int = 256):
    """Throughput at 1, 2, 4, ... local devices; efficiency vs linear.

    On a one-chip host this returns a single point; on a pod slice it
    measures the DP scaling curve (>= 85%% multi-host
    efficiency).
    """
    from ..utils.profiling import throughput
    from .mesh import make_mesh, place_batch, sharded_engine

    rng = np.random.default_rng(0)
    points: list[ScalingPoint] = []
    total = len(jax.devices())
    d = 1
    base_rate = None
    while d <= total:
        mesh = make_mesh(d, batch_axis=d)
        batch = batch_per_device * d
        sig = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
        pk = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
        hm = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
        args = place_batch(mesh, sig, pk, hm)
        run = sharded_engine(n, mesh)
        rate, _ = throughput(run, args, items_per_call=batch)
        if base_rate is None:
            base_rate = rate / d
        points.append(
            ScalingPoint(d, rate, rate / (base_rate * d) if base_rate else 1.0)
        )
        d *= 2
    return points
