#!/usr/bin/env python3
"""Two-process jax.distributed smoke test on CPU: the multi-host path.

Validates the framework's cross-host machinery without a pod: two local
processes form a jax.distributed cluster (gloo collectives), each
contributes 4 virtual CPU devices to a global 8-device (batch, coeff)
mesh, assembles its host-local signature shard into globally-sharded
arrays, and runs the sharded witness engine one step.

    python tools/multihost_smoke.py            # launcher (spawns 2 workers)
    python tools/multihost_smoke.py --worker I # worker process
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(proc_id: int, port: int, num_procs: int = 2) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == num_procs
    assert len(jax.devices()) == 4 * num_procs

    sys.path.insert(0, str(ROOT))
    import numpy as np

    from falcon_r1cs_tpu.parallel.distributed import (
        global_mesh,
        host_local_batch,
        make_global_arrays,
    )
    from falcon_r1cs_tpu.parallel.mesh import sharded_engine

    n = 512
    global_batch = 8
    mesh = global_mesh(batch_axis=4)
    rng = np.random.default_rng(100 + proc_id)
    local = host_local_batch(rng, n, global_batch)
    sig, pk, hm = make_global_arrays(mesh, local, global_batch, n)
    run = sharded_engine(n, mesh)
    out = run(sig, pk, hm)
    jax.block_until_ready(out)
    assert out["sig_ntt_b"].shape == (global_batch, n)
    print(f"[worker {proc_id}] multihost step OK "
          f"(procs={jax.process_count()}, devices={len(jax.devices())})",
          flush=True)

    # throughput point: a timed cross-process sharded-
    # engine loop at a real batch.  Every worker must run every step
    # (collective programs are SPMD); worker 0's clock is the record.
    import time

    bench_batch = 512
    local_b = host_local_batch(rng, n, bench_batch)
    bsig, bpk, bhm = make_global_arrays(mesh, local_b, bench_batch, n)
    jax.block_until_ready(run(bsig, bpk, bhm))  # compile + warm
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(bsig, bpk, bhm)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    print(f"[worker {proc_id}] gloo 2-process throughput: "
          f"{bench_batch * iters / dt:.1f} wit/s "
          f"(falcon-{n}, global batch {bench_batch}, {iters} steps)",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.port)
        return
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), "--port", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=420)
        text = out.decode()
        if p.returncode != 0 or "multihost step OK" not in text:
            ok = False
            print(f"worker {i} FAILED:\n{text[-2000:]}")
        else:
            print(text.strip().splitlines()[-1])
    if not ok:
        sys.exit(1)
    print("multihost smoke: PASS")


if __name__ == "__main__":
    main()
