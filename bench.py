"""Benchmark: batched witnesses/sec for Falcon-1024 verify-with-NTT on one
NVIDIA GPU.

Prints ONE JSON line {"metric", "value", "unit", "device", ...}.  The
headline is the device-profiled engine rate (union of the GPU's busy
intervals in a jax.profiler trace); the wall-clock rate is the slope of
total time against pipelined iteration count (utils/profiling.py).  It
refuses to run when JAX finds no GPU: a CPU number is never reported
under a device metric.

Extra keys: dual/schoolbook engine rates, constraint-synthesis rate of the
trace layer, native hash-to-point rate, the wire-bytes pipeline, and the
host Groth16 prover.

    python bench.py
"""

import json
import os
import time

import numpy as np


def _inputs(batch, n, signed=False):
    from falcon_r1cs_tpu.params import Q

    rng = np.random.default_rng(0)
    if signed:
        sig = rng.integers(-1000, 1001, size=(batch, n)).astype(np.int32)
    else:
        sig = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    pk = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    return sig, pk, hm


def bench_witnesses(batch=1024, n=1024):
    from falcon_r1cs_tpu.utils.profiling import throughput
    from falcon_r1cs_tpu.witness.engine import jitted_engine

    args = _inputs(batch, n)
    rate, _ = throughput(jitted_engine(n), args, items_per_call=batch)
    return rate


def _device_rate(fn, args, items, iters=3):
    """Device-profiled rate for any jitted callable: the GPU's busy time
    from a jax.profiler trace (device_time_us_from_trace), excluding
    host dispatch overhead.  Returns None when the trace holds no device
    rows."""
    import shutil
    import tempfile

    import jax

    jax.block_until_ready(fn(*args))
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        jax.profiler.start_trace(tmp)
        try:
            out = None
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
        finally:
            jax.profiler.stop_trace()  # never leave the profiler running
        dev_us = device_time_us_from_trace(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not dev_us:
        return None
    return items * iters / (dev_us / 1e6)


def bench_witnesses_device(batch=1024, n=1024, iters=3):
    from falcon_r1cs_tpu.witness.engine import jitted_engine

    args = _inputs(batch, n)
    return _device_rate(jitted_engine(n), args, batch, iters)


def _is_device_row(pid_name: str, tid_name: str) -> bool:
    """A row of device work in a GPU trace: a "/device:GPU:<i>" process,
    and on it the per-op row ("XLA Ops") or a CUDA stream row
    ("Stream #<id>..."), not the whole-module span row ("XLA Modules"),
    whose spans also cover the gaps between a module's kernels."""
    return pid_name.startswith("/device:GPU") and (
        tid_name == "XLA Ops" or tid_name.startswith("Stream")
    )


def device_time_us_from_trace(trace_dir: str):
    """Device busy time (us) in a jax.profiler trace: the UNION of the
    device rows' event intervals over every GPU in the trace.

    A union, not a duration sum: the per-op row and the stream rows
    report the same kernels, and control-flow ops (lax.map/scan
    `while`s) are emitted as one event spanning the loop AND as their
    inner ops, so a sum would count work two or three times."""
    import glob
    import gzip

    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        return None
    with gzip.open(paths[-1]) as f:
        data = json.load(f)
    pid_names = {}
    tid_names = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                pid_names[e["pid"]] = e["args"].get("name", "")
            elif e.get("name") == "thread_name":
                tid_names[(e["pid"], e.get("tid"))] = e["args"].get(
                    "name", ""
                )
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"])
        for e in data["traceEvents"]
        if e.get("ph") == "X" and "dur" in e
        and _is_device_row(
            pid_names.get(e.get("pid"), ""),
            tid_names.get((e.get("pid"), e.get("tid")), ""),
        )
    )
    busy = 0.0
    cur_s = cur_e = None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def bench_dual(batch=512, n=1024):
    """Device-profiled when possible, wall-clock slope otherwise."""
    from falcon_r1cs_tpu.utils.profiling import throughput
    from falcon_r1cs_tpu.witness.engine_dual import jitted_engine_dual

    args = _inputs(batch, n, signed=True)
    fn = jitted_engine_dual(n)
    rate = _device_rate(fn, args, batch)
    if rate is None:
        rate, _ = throughput(fn, args, items_per_call=batch)
    return rate


def bench_schoolbook(batch=128, n=1024):
    from falcon_r1cs_tpu.utils.profiling import throughput
    from falcon_r1cs_tpu.witness.engine_schoolbook import (
        jitted_engine_schoolbook,
    )

    args = _inputs(batch, n)
    fn = jitted_engine_schoolbook(n)
    rate = _device_rate(fn, args, batch)
    if rate is None:
        rate, _ = throughput(fn, args, items_per_call=batch)
    return rate


def bench_constraint_synthesis(n=1024, trials=3):
    """Constraints synthesized per second by the trace layer
    (Falcon-1024 verify-with-NTT, 162,870 constraints).

    Best-of-N: a shared host's CPU clock makes single-shot rates drift
    up to 2x between identical runs."""
    from falcon_r1cs_tpu import ConstraintSystem, FalconNTTVerificationCircuit
    from falcon_r1cs_tpu.falcon import make_instance
    from falcon_r1cs_tpu.params import get_params

    rng = np.random.default_rng(1)
    inst = make_instance(rng, get_params(n))
    expected = {512: 81460, 1024: 162870}[n]
    best = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        cs = ConstraintSystem()
        FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(
            cs
        )
        dt = time.perf_counter() - t0
        assert cs.num_constraints == expected
        best = max(best, cs.num_constraints / dt)
    return best


def bench_direct_synthesis(n=1024, trials=3):
    """Structured direct COO emission rate (schoolbook-n, the largest
    circuit; bit-identical to the traced matrices — r1cs/direct.py)."""
    from falcon_r1cs_tpu.r1cs.direct import direct_compile_schoolbook

    compiled = direct_compile_schoolbook(n)  # warm (NTT matrix N/A here)
    best = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        compiled = direct_compile_schoolbook(n)
        best = max(best, compiled.num_constraints / (time.perf_counter() - t0))
    return best


def bench_hash_to_point(batch=4096, n=1024, trials=5):
    """Best-of-N: a shared host's CPU clock ramps over seconds under load,
    so single-shot rates under-report; best-of reflects the hardware."""
    try:
        from falcon_r1cs_tpu.native import native_hash_to_point_batch
    except Exception:
        return None
    msgs = [b"benchmark message %d" % i for i in range(batch)]
    nonces = [bytes(40) for _ in range(batch)]
    native_hash_to_point_batch(msgs[:64], nonces[:64], n)  # warm build
    best = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        native_hash_to_point_batch(msgs, nonces, n)
        best = max(best, batch / (time.perf_counter() - t0))
    return best


_PIPE: dict = {}


def _pipeline_setup(batch=512, n=1024):
    """Build the pipeline inputs + object once (host-only, a few s)."""
    from falcon_r1cs_tpu.falcon import compress_signature, encode_public_key
    from falcon_r1cs_tpu.params import Q, get_params
    from falcon_r1cs_tpu.pipeline import ProverInputPipeline

    params = get_params(n)
    rng = np.random.default_rng(3)
    h = rng.integers(0, Q, size=(batch, n), dtype=np.int64)
    # Gaussian at the spec sigma — the Golomb-Rice budget is tuned for it
    s2 = np.rint(rng.normal(0, 165, size=(batch, n))).astype(np.int64)
    pk_bytes = [encode_public_key(h[i], params) for i in range(batch)]
    sig_bytes = [
        compress_signature(s2[i], bytes([i & 0xFF] * 40), params)
        for i in range(batch)
    ]
    msgs = [b"pipeline bench %d" % i for i in range(batch)]
    _PIPE.update(
        batch=batch,
        pipe=ProverInputPipeline(params, pack=False),
        pk_bytes=pk_bytes,
        sig_bytes=sig_bytes,
        msgs=msgs,
    )


def _pipeline_run_once():
    import jax

    jax.block_until_ready(
        _PIPE["pipe"].run_wire(
            _PIPE["pk_bytes"], _PIPE["msgs"], _PIPE["sig_bytes"]
        ).seg
    )


def bench_pipeline(trials=3):
    """End-to-end wire-bytes -> witness-segments rate (decode + SIMD
    hash-to-point + device NTTs + witness engine).

    ONE compiled shape (batch=512), measured as an ITERATION-COUNT
    slope: rate = 2*batch / (t(3 calls) - t(1 call)), which cancels
    every fixed per-call cost while keeping all per-item host AND device
    work."""
    if not _PIPE:
        _pipeline_setup()
    _pipeline_run_once()  # compile + warm
    batch = _PIPE["batch"]
    best = 0.0
    single = 0.0
    # host-clock noise can make t(3) < t(1); retry the slope a few times
    # and fall back to the (pessimistic) single-call rate
    for _ in range(trials):
        t0 = time.perf_counter()
        _pipeline_run_once()
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            _pipeline_run_once()
        t_three = time.perf_counter() - t0
        single = max(single, 3 * batch / t_three)
        if t_three > t_one:
            best = max(best, 2 * batch / (t_three - t_one))
        if best:
            break
    return best if best else single


def bench_pipeline_device(iters=3):
    """Device-profiled compute rate of the SAME wire-bytes -> witness
    path bench_pipeline times with wall clock: GPU busy time from a
    jax.profiler trace around whole-pipeline calls.  The pair separates
    device compute from the host stages around it."""
    import shutil
    import tempfile

    import jax

    if not _PIPE:
        _pipeline_setup()
    _pipeline_run_once()
    batch = _PIPE["batch"]
    tmp = tempfile.mkdtemp(prefix="bench_pipe_trace_")
    try:
        jax.profiler.start_trace(tmp)
        try:
            for _ in range(iters):
                _pipeline_run_once()
        finally:
            jax.profiler.stop_trace()
        dev_us = device_time_us_from_trace(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not dev_us:
        return None
    return batch * iters / (dev_us / 1e6)


def bench_groth16(n=512, prove_iters=3):
    """Groth16 proofs/sec over the falcon-512 verify-NTT circuit (host +
    native C backend; the reference's pok_sig.rs capability).  CRS and
    compiled R1CS are disk-cached, so steady-state cost is prove-only."""
    from falcon_r1cs_tpu import ConstraintSystem, FalconNTTVerificationCircuit
    from falcon_r1cs_tpu.falcon import make_instance
    from falcon_r1cs_tpu.params import get_params
    from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
    from falcon_r1cs_tpu.snark import prove, setup, verify
    from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk

    rng = np.random.default_rng(5)
    inst = make_instance(rng, get_params(n))
    compiled = compile_circuit(FalconNTTVerificationCircuit, inst)
    cs = ConstraintSystem(mode="prove")
    FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(cs)
    assignment = list(cs.instance_values) + list(cs.witness_values)
    crs_path = cache_dir() / f"FalconNTTVerificationCircuit_{n}.pk.npz"
    if crs_path.exists():
        pk = load_pk(crs_path)
    else:
        pk = setup(compiled)
        cache_dir().mkdir(parents=True, exist_ok=True)
        save_pk(pk, crs_path)
    # production form: one up-front limb conversion, zero Python bigints
    # inside the timed loop (points.packed_to_limb_rows is the device-
    # packer equivalent of this)
    from falcon_r1cs_tpu.snark.points import ints_to_limbs

    try:
        assignment = ints_to_limbs([int(x) for x in assignment], 4)
    except (OverflowError, TypeError, ValueError):
        pass  # pure-Python fallback keeps the int list
    proof = prove(pk, compiled, assignment)  # warm native build
    t0 = time.perf_counter()
    for _ in range(prove_iters):
        proof = prove(pk, compiled, assignment)
    rate = prove_iters / (time.perf_counter() - t0)
    assert verify(pk.vk, list(cs.instance_values), proof)
    _GROTH16_CTX.update(pk=pk, compiled=compiled, assignment=assignment,
                        instance=list(cs.instance_values))
    return rate


_GROTH16_CTX: dict = {}


def _batch_assignments(K, n=512):
    """K DISTINCT satisfying assignments (prove-mode traced synthesis of
    K seeded instances), disk-cached as one limb tensor so only the first
    bench run on a host pays the ~1.1 s/instance synthesis cost."""
    from falcon_r1cs_tpu.r1cs.coo import cache_dir

    path = cache_dir() / f"bench_batch_assignments_ntt{n}_K{K}.npz"
    if path.exists():
        d = np.load(path)
        return list(d["z"]), [[int(v) for v in p] for p in d["pub"]]

    from falcon_r1cs_tpu import (
        ConstraintSystem,
        FalconNTTVerificationCircuit,
    )
    from falcon_r1cs_tpu.falcon import make_instance
    from falcon_r1cs_tpu.params import get_params
    from falcon_r1cs_tpu.snark.points import ints_to_limbs

    zs, pubs = [], []
    for k in range(K):
        rng = np.random.default_rng(100 + k)
        inst = make_instance(rng, get_params(n))
        cs = ConstraintSystem(mode="prove")
        FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(
            cs
        )
        pub = [int(x) for x in cs.instance_values]
        zs.append(ints_to_limbs(pub + [int(x) for x in cs.witness_values], 4))
        pubs.append(pub)
    cache_dir().mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, z=np.stack(zs), pub=np.array(pubs, dtype=np.uint64)
    )
    return zs, pubs


def bench_groth16_batch(K=16):
    """Batched proving rate (prove_batch, one CRS x K DISTINCT
    assignments — the falcon-aggregate-sig shape,
    /root/reference/falcon-aggregate-sig/src/main.rs:1-3).

    prove_batch is WARMED before timing (a cold call measures the native
    build and point caches), the K assignments are distinct instances,
    ALL K proofs are verified, and singles are timed interleaved around
    the batch in the same run so the speedup ratio cancels host-clock
    drift."""
    from falcon_r1cs_tpu.snark import prove, prove_batch, verify

    if not _GROTH16_CTX:
        bench_groth16()
    pk = _GROTH16_CTX["pk"]
    compiled = _GROTH16_CTX["compiled"]
    zs, pubs = _batch_assignments(K)
    prove_batch(pk, compiled, zs[:2])  # warm native build + point caches

    # interleave: single, batch, single — ratio from the same host minute
    t0 = time.perf_counter()
    p0 = prove(pk, compiled, zs[0])
    t_s0 = time.perf_counter() - t0
    t0 = time.perf_counter()
    proofs = prove_batch(pk, compiled, zs)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1 = prove(pk, compiled, zs[1])
    t_s1 = time.perf_counter() - t0
    t_single = (t_s0 + t_s1) / 2

    assert verify(pk.vk, pubs[0], p0)
    assert verify(pk.vk, pubs[1], p1)
    for k in range(K):
        assert verify(pk.vk, pubs[k], proofs[k]), k
    _GROTH16_CTX["batch_speedup"] = round(t_single * K / t_batch, 2)
    return K / t_batch


def main():
    import jax

    from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX's default device is {dev}"
        )
    # time-box the secondary stages so the headline always lands; a
    # stage that does not fit is reported as skipped, never dropped
    budget_s = float(os.environ.get("BENCH_BUDGET_SECS", "560"))
    start = time.perf_counter()

    wps_wall = bench_witnesses()
    wps_dev = bench_witnesses_device()
    result = {
        "metric": "witnesses_per_sec_falcon1024_verify_ntt",
        "value": round(wps_dev or wps_wall, 1),
        "unit": "witness/s",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "wallclock_witnesses_per_sec": round(wps_wall, 1),
        "device_profiled": wps_dev is not None,
    }

    def remaining():
        return budget_s - (time.perf_counter() - start)

    secondary = [
        ("constraints_synthesized_per_sec", bench_constraint_synthesis, 30),
        ("direct_synthesis_cns_per_sec", bench_direct_synthesis, 30),
        ("hash_to_point_per_sec", lambda: bench_hash_to_point() or 0, 30),
        ("groth16_proves_per_sec", bench_groth16, 90),
        ("groth16_batch16_proves_per_sec", bench_groth16_batch, 60),
        ("pipeline_witnesses_per_sec", bench_pipeline, 100),
        ("pipeline_device_witnesses_per_sec",
         lambda: bench_pipeline_device() or 0, 30),
        ("dual_ntt_witnesses_per_sec", bench_dual, 120),
        ("schoolbook_witnesses_per_sec", bench_schoolbook, 120),
    ]
    import signal

    def _alarmed(fn, seconds):
        """Run fn under a hard SIGALRM deadline: one stage that hangs
        costs its own budget, never the whole bench."""

        def _raise(sig, frame):
            raise TimeoutError("bench stage deadline")

        prev = signal.signal(signal.SIGALRM, _raise)
        signal.alarm(max(1, int(seconds)))
        try:
            return fn()
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, prev)

    stage_seconds = {}
    for key, fn, cost in secondary:
        if remaining() < cost:
            result[key] = "skipped: bench budget spent"
            continue
        t_stage = time.perf_counter()
        try:
            result[key] = round(
                _alarmed(fn, min(3 * cost, remaining())), 1
            )
        except Exception as e:  # never let a secondary kill the metric
            result[key] = f"error: {type(e).__name__}"
        stage_seconds[key] = round(time.perf_counter() - t_stage, 1)
    if "batch_speedup" in _GROTH16_CTX:
        # interleaved same-run ratio: host-clock drift cancels
        result["groth16_batch_speedup_vs_singles"] = _GROTH16_CTX[
            "batch_speedup"
        ]
    result["stage_seconds"] = stage_seconds
    print(json.dumps(result))


if __name__ == "__main__":
    main()
