"""The CUDA hint-NTT kernel against the XLA path, on the GPU.

For n = 512 and 1024 at B = 1024: bit-equality of ops/ntt_cuda against
ops/ntt_limb.ntt_with_hints, the best-of wall time of each, and the device
time and kernel launches per call from a jax.profiler trace.  Then the same
for the verify-NTT and dual witness engines built on each backend, and for
the schoolbook engine (XLA only) at B = 64.  With --msm, the device G1 MSM
at 2^14 points against the native C MSM.

    python tools/ntt_kernel_bench.py [--msm] [--out DIR]

Per-kernel trace rows go to DIR (default bench_out/ntt_kernel_bench).
"""

from __future__ import annotations

import argparse
import collections
import functools
import gzip
import glob
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np


def best_of(fn, args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def trace(fn, args, iters=5):
    """(device busy us per call, {row: [(kernel, dur_us)]} per call)."""
    import jax

    from bench import _is_device_row, device_time_us_from_trace

    jax.block_until_ready(fn(*args))
    tmp = tempfile.mkdtemp(prefix="ntt_trace_")
    try:
        jax.profiler.start_trace(tmp)
        try:
            out = None
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
        finally:
            jax.profiler.stop_trace()
        busy = device_time_us_from_trace(tmp)
        path = sorted(glob.glob(f"{tmp}/plugins/profile/*/*.trace.json.gz"))
        with gzip.open(path[-1]) as f:
            data = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pid, tid = {}, {}
    for e in data["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    rows = collections.defaultdict(list)
    for e in data["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        p = pid.get(e.get("pid"), "")
        t = tid.get((e.get("pid"), e.get("tid")), "")
        if p.startswith("/device:"):
            rows[f"{p} | {t} | device_row={_is_device_row(p, t)}"].append(
                (e.get("name", ""), e["dur"])
            )
    return (busy or 0.0) / iters, rows


def report(label, fn, args, out_dir, items):
    wall = best_of(fn, args)
    busy, rows = trace(fn, args)
    launches = {r: len(ev) / 5 for r, ev in rows.items()}
    print(f"{label}: wall {wall * 1e3:.3f} ms (best of 20), device "
          f"{busy / 1e3:.3f} ms/call, {items / (busy / 1e6):,.0f} items/s "
          f"device; events per call by row: {launches}", flush=True)
    with open(out_dir / f"{label.replace(' ', '_')}.json", "w") as f:
        summary = {}
        for r, ev in rows.items():
            agg = collections.defaultdict(lambda: [0, 0.0])
            for name, dur in ev:
                agg[name][0] += 1
                agg[name][1] += dur
            summary[r] = sorted(
                ([k, c / 5, d / 5] for k, (c, d) in agg.items()),
                key=lambda x: -x[2],
            )
        json.dump({"wall_s": wall, "device_us": busy, "rows": summary}, f,
                  indent=1)
    return wall, busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--msm", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "bench_out" /
                                         "ntt_kernel_bench"))
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    import jax

    from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is {dev}")
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {dev.device_kind}; nvidia-smi: {smi}", flush=True)

    from falcon_r1cs_tpu.ops.ntt_cuda import ntt_with_hints_cuda
    from falcon_r1cs_tpu.ops.ntt_limb import ntt_with_hints
    from falcon_r1cs_tpu.params import Q, get_params

    rng = np.random.default_rng(0)
    B = 1024
    from falcon_r1cs_tpu.witness.engine import _jitted_engine
    from falcon_r1cs_tpu.witness.engine_dual import _jitted_engine_dual
    from falcon_r1cs_tpu.witness.engine_schoolbook import (
        jitted_engine_schoolbook,
    )

    n = 1024
    sig = rng.integers(0, Q, size=(B, n), dtype=np.int32)
    pk = rng.integers(0, Q, size=(B, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(B, n), dtype=np.int32)
    signed = rng.integers(-600, 601, size=(B, n)).astype(np.int32)
    for label, make, s in (("engine", _jitted_engine, sig),
                           ("dual", _jitted_engine_dual, signed)):
        outs = {}
        for backend in ("xla", "cuda"):
            fn = make(n, backend)
            t0 = time.perf_counter()
            outs[backend] = jax.block_until_ready(fn(s, pk, hm))
            first = time.perf_counter() - t0
            print(f"{label} {backend}: first call {first:.1f} s", flush=True)
            report(f"{label} {backend} n{n}", fn, (s, pk, hm), out_dir, B)
        for k in outs["xla"]:
            assert np.array_equal(np.asarray(outs["xla"][k]),
                                  np.asarray(outs["cuda"][k])), (label, k)
        print(f"{label}: cuda engine == xla engine bit for bit", flush=True)
        del outs

    # the bare hint NTTs: one jit object per implementation, the
    # parameter set static
    xla_jit = jax.jit(ntt_with_hints, static_argnums=1)
    cuda_jit = jax.jit(ntt_with_hints_cuda, static_argnums=1)
    for n in (512, 1024):
        params = get_params(n)
        x = rng.integers(0, Q, size=(B, n)).astype(np.int32)
        xla = functools.partial(xla_jit, params=params)
        cuda = functools.partial(cuda_jit, params=params)
        t0 = time.perf_counter()
        got = jax.block_until_ready(cuda(x))
        t_first = time.perf_counter() - t0
        want = xla(x)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), n
        print(f"hint NTT n={n} B={B}: cuda == xla bit for bit "
              f"(first cuda call incl. build {t_first:.1f} s)", flush=True)
        report(f"ntt xla n{n}", xla, (x,), out_dir, B)
        report(f"ntt cuda n{n}", cuda, (x,), out_dir, B)

    sb = 64
    fn = jitted_engine_schoolbook(n)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(sig[:sb], pk[:sb], hm[:sb]))
    print(f"schoolbook: first call {time.perf_counter() - t0:.1f} s",
          flush=True)
    wall, busy = report(f"schoolbook xla n{n} B{sb}", fn,
                        (sig[:sb], pk[:sb], hm[:sb]), out_dir, sb)
    prod_bytes = sb * n * n * 4
    print(f"schoolbook: product tensor {prod_bytes / 2**20:.0f} MiB; one "
          f"write of it in the device time is "
          f"{prod_bytes / (busy / 1e6) / 1e12:.3f} TB/s", flush=True)

    if args.msm:
        msm_check(rng)



def msm_check(rng, log_n=14):
    """The device MSM at 2^log_n points against the native C MSM."""
    from falcon_r1cs_tpu.snark import bls12_381 as bls
    from falcon_r1cs_tpu.snark import native_backend, tpu_msm
    from falcon_r1cs_tpu.snark.points import ints_to_limbs

    m = 1 << log_n
    rand = lambda: [int.from_bytes(rng.bytes(32), "little") % bls.R
                    for _ in range(m)]
    pts = native_backend.g1_fixed_base_batch(rand())
    scalars = ints_to_limbs(rand(), 4)
    want = native_backend.g1_msm(pts, scalars)
    t0 = time.perf_counter()
    got = tpu_msm.g1_msm_tpu(pts, scalars)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpu_msm.g1_msm_tpu(pts, scalars)
    warm = time.perf_counter() - t0
    print(f"msm 2^{log_n}: equal to native C = {got == want}; cold "
          f"{cold:.1f} s, warm {warm:.3f} s", flush=True)

if __name__ == "__main__":
    main()
