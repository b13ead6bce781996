#!/usr/bin/env python3
"""Measure pipeline parallelism (parallel/pipeline_pp.py) against data
parallelism on the same device mesh, same total work — the evidence
behind PARITY_NOTES.md's "PP is dominated by DP here" conclusion
(the strategy had to be built or justified with measurements; this does
both).

Runs on the virtual CPU mesh by default (the only multi-device option in
this environment):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/pp_vs_dp.py [n_devices] [n] [microbatch] [n_micro]

Reports wall time for the identical batch of forward NTTs, the analytic
bubble fraction, and the per-stage bytes PP moves between devices that
DP does not.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    # the virtual CPU mesh: set before any backend query
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from falcon_r1cs_tpu.params import get_params
    from falcon_r1cs_tpu.parallel import pipeline_pp

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    mb = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    T = int(sys.argv[4]) if len(sys.argv) > 4 else 64

    params = get_params(n)
    devs = jax.devices()
    if len(devs) < S:
        raise SystemExit(
            f"need {S} devices, have {len(devs)} — run with "
            "XLA_FLAGS=--xla_force_host_platform_device_count=8"
        )
    mesh = Mesh(np.asarray(devs[:S]), ("stage",))
    rng = np.random.default_rng(0)
    x = rng.integers(0, params.q, size=(T * mb, n)).astype(np.int32)
    xj = jnp.asarray(x)

    pp = pipeline_pp.pp_ntt(mesh, params, microbatch=mb, n_micro=T)
    dp = pipeline_pp.dp_ntt(mesh, params)

    out_pp = np.asarray(pp(xj))
    out_dp = np.asarray(dp(xj))
    np.testing.assert_array_equal(out_pp, out_dp)

    def best_of(f, k=5):
        ts = []
        for _ in range(k):
            t0 = time.perf_counter()
            jax.block_until_ready(f(xj))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_pp = best_of(pp)
    t_dp = best_of(dp)
    bubble = (S - 1) / (T + S - 1)
    ici_bytes = (T + S - 2) * mb * n * 4  # one (mb, n) int32 per conveyor step
    print(f"devices={S} n={n} batch={T * mb} (T={T} x mb={mb})")
    print(f"DP:  {t_dp * 1e3:8.2f} ms   (0 inter-device bytes)")
    print(f"PP:  {t_pp * 1e3:8.2f} ms   ({t_pp / t_dp:.2f}x DP; analytic "
          f"bubble {bubble:.1%}; conveyor traffic {ici_bytes / 1e6:.1f} MB "
          f"+ full-output psum)")


if __name__ == "__main__":
    main()
