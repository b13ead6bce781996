"""Smoke run of the whole proving path on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

Phases (one card), each failing loudly:

  1. device    refuse anything but a GPU; print its kind, nvidia-smi's
               name and power limit, the JAX version and the compile cache
  2. engines   the verify-NTT and dual-NTT witness engines at Falcon-1024,
               B = 1024, and the schoolbook engine at B = 64; two rows of
               each batch are real signatures whose packed witnesses must
               equal the host trace's `cs.witness_values` bit for bit
  3. kernel    the hint-NTT kernel the GPU selects against the XLA path
               (ops/ntt_limb.ntt_with_hints), bit for bit, n = 512 and 1024
               at B = 1024, with both timings
  4. main path 256 Falcon-1024 wire-format triples through
               ProverInputPipeline.run_wire and the device CRT
               satisfiability check; a tampered message rejected by
               verify_batch; prove_batch on two of them from the device
               packer's assignments, and both proofs verify
  5. msm       the device G1 MSM (snark/tpu_msm.py) at 2^14 points against
               the native C MSM, bit for bit

With --four: the batch-sharded verify-NTT, dual and schoolbook engines on
a 4-card batch mesh, the verify-NTT engine on a 2 x 2 (batch, coeff) mesh,
and the row-sharded CRT check, each against the one-card result.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
It is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
# the shapes of the run: Falcon-1024 at the engines' benchmark batch
N = 1024
ENGINE_BATCH = 1024
SCHOOLBOOK_BATCH = 64   # 64 x 1024 x 1024 int32 products: 256 MiB
PIPELINE_K = 256
PROVE_K = 2
MSM_LOG_N = 14
KERNEL_BATCH = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# --- phase 1 ---------------------------------------------------------------


def phase_device(expect_count: int):
    import jax

    from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's default device is {devs[0]}"
        )
    if len(devs) < expect_count:
        raise SystemExit(f"need {expect_count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device: {devs[0].device_kind} x {len(devs)} "
        f"(jax {jax.__version__})")
    log(f"nvidia-smi: {smi}")
    log(f"compile cache: {cache}")
    return devs


# --- phase 2 ---------------------------------------------------------------


def _real_and_random(rng, params, batch, real=2):
    from falcon_r1cs_tpu.falcon import make_instance

    insts = [make_instance(rng, params, msg=b"smoke %d" % i)
             for i in range(real)]
    return insts, batch - real


def _packed_equals_trace(packed_row, inst, circuit_cls) -> bool:
    """One signature's device-packed witness (W, limbs) u32 against the
    host trace's cs.witness_values, as 4 x u64 canonical limbs."""
    from falcon_r1cs_tpu import ConstraintSystem
    from falcon_r1cs_tpu.snark.points import ints_to_limbs

    cs = ConstraintSystem()
    circuit_cls.build_circuit(inst).generate_constraints(cs)
    host = ints_to_limbs([int(x) for x in cs.witness_values], 4)
    p = np.asarray(packed_row).view(np.uint32).astype(np.uint64)
    p = np.concatenate(
        [p, np.zeros((p.shape[0], 8 - p.shape[1]), np.uint64)], axis=1
    )
    dev = p[:, 0::2] | (p[:, 1::2] << np.uint64(32))
    return dev.shape == host.shape and bool(np.array_equal(dev, host))


def engine_batches(rng, params):
    """Inputs of the three engines: two real signatures each, the rest
    seeded random input of the right ranges."""
    from falcon_r1cs_tpu.falcon import ntt
    from falcon_r1cs_tpu.params import Q

    n = params.n
    out = {}
    insts, rest = _real_and_random(rng, params, ENGINE_BATCH)
    sig = np.concatenate([
        np.stack([i.sig_lifted for i in insts]),
        rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    pk = np.concatenate([
        np.stack([ntt(i.h) for i in insts]),
        rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    hm = np.concatenate([
        np.stack([ntt(i.hm) for i in insts]),
        rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    out["ntt"] = (insts, (sig, pk, hm))

    insts, rest = _real_and_random(rng, params, ENGINE_BATCH)
    sig = np.concatenate([
        np.stack([i.sig_signed for i in insts]),
        rng.integers(-600, 601, size=(rest, n)),
    ]).astype(np.int32)
    pk = np.concatenate([
        np.stack([ntt(i.h) for i in insts]),
        rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    hm = np.concatenate([
        np.stack([ntt(i.hm) for i in insts]),
        rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    out["dual"] = (insts, (sig, pk, hm))

    insts, rest = _real_and_random(rng, params, SCHOOLBOOK_BATCH)
    sig = np.concatenate([
        np.stack([i.sig_lifted for i in insts]),
        rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    pk = np.concatenate([
        np.stack([i.h for i in insts]), rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    hm = np.concatenate([
        np.stack([i.hm for i in insts]), rng.integers(0, Q, size=(rest, n)),
    ]).astype(np.int32)
    out["schoolbook"] = (insts, (sig, pk, hm))
    return out


def phase_engines(rng, params):
    from falcon_r1cs_tpu import (
        FalconDualNTTVerificationCircuit,
        FalconNTTVerificationCircuit,
        FalconSchoolBookVerificationCircuit,
    )
    from falcon_r1cs_tpu.ops.backend import configured_ntt_backend
    from falcon_r1cs_tpu.witness.engine import jitted_engine
    from falcon_r1cs_tpu.witness.engine_dual import jitted_engine_dual
    from falcon_r1cs_tpu.witness.engine_schoolbook import (
        jitted_engine_schoolbook,
    )
    from falcon_r1cs_tpu.witness.export_device import (
        packer_dual,
        packer_ntt,
        packer_schoolbook,
    )

    import jax

    n = params.n
    log(f"hint-NTT backend: {configured_ntt_backend()}")
    batches = engine_batches(rng, params)
    cases = [
        ("ntt", jitted_engine(n), packer_ntt(n),
         FalconNTTVerificationCircuit),
        ("dual", jitted_engine_dual(n), packer_dual(n),
         FalconDualNTTVerificationCircuit),
        ("schoolbook", jitted_engine_schoolbook(n), packer_schoolbook(n),
         FalconSchoolBookVerificationCircuit),
    ]
    for name, engine, packer, circuit_cls in cases:
        insts, args = batches[name]
        args = jax.device_put(args)  # time the engine, not the upload
        seg, cold = timed(engine, *args)
        seg, warm = timed(engine, *args)
        packed, t_pack = timed(packer, seg)
        rows = np.asarray(packed[: len(insts)])
        del seg, packed
        for b, inst in enumerate(insts):
            if not _packed_equals_trace(rows[b], inst, circuit_cls):
                raise AssertionError(
                    f"{name} engine row {b} != host trace witness"
                )
        log(f"engine {name}-{n} B={args[0].shape[0]}: bit-exact vs host "
            f"trace on {len(insts)} real signatures; cold {cold:.2f} s, "
            f"warm {warm * 1e3:.2f} ms, pack {t_pack:.2f} s")
    return batches


# --- phase 3 ---------------------------------------------------------------


def _best_of(fn, x, reps=10):
    import jax

    jax.block_until_ready(fn(x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernel(rng):
    import jax

    from falcon_r1cs_tpu.ops.backend import configured_ntt_backend
    from falcon_r1cs_tpu.ops.ntt_limb import ntt_hints, ntt_with_hints
    from falcon_r1cs_tpu.params import Q, get_params

    backend = configured_ntt_backend()
    if backend == "xla":
        log("kernel: the GPU selects the XLA hint NTT; no kernel to compare")
        return
    # one jit object per implementation, the parameter set static (a
    # closure per loop iteration would be a new function each time)
    ref_jit = jax.jit(ntt_with_hints, static_argnums=1)
    ker_jit = jax.jit(ntt_hints, static_argnums=(1, 2))
    for n in (512, 1024):
        params = get_params(n)
        x = jax.device_put(
            rng.integers(0, Q, size=(KERNEL_BATCH, n)).astype(np.int32)
        )
        ref = functools.partial(ref_jit, params=params)
        ker = functools.partial(ker_jit, params=params, backend=backend)
        (t_ref, b_ref), _ = timed(ref, x)
        (t_k, b_k), cold = timed(ker, x)
        if not (np.array_equal(np.asarray(t_ref), np.asarray(t_k))
                and np.array_equal(np.asarray(b_ref), np.asarray(b_k))):
            raise AssertionError(f"{backend} hint NTT != XLA at n={n}")
        log(f"kernel {backend} n={n} B={KERNEL_BATCH}: bit-exact vs XLA; "
            f"{backend} {_best_of(ker, x) * 1e3:.3f} ms, "
            f"xla {_best_of(ref, x) * 1e3:.3f} ms (best of 10); "
            f"kernel cold {cold:.2f} s")


# --- phase 4 ---------------------------------------------------------------


def phase_main_path(rng, params):
    import jax

    from falcon_r1cs_tpu import FalconNTTVerificationCircuit
    from falcon_r1cs_tpu.falcon import (
        compress_signature,
        encode_public_key,
        make_instance,
        verify_batch,
    )
    from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem
    from falcon_r1cs_tpu.pipeline import ProverInputPipeline
    from falcon_r1cs_tpu.r1cs.coo import cache_dir, compile_circuit
    from falcon_r1cs_tpu.snark import (
        native_backend,
        prove_batch,
        setup,
        verify,
    )
    from falcon_r1cs_tpu.snark.groth16 import load_pk, save_pk
    from falcon_r1cs_tpu.snark.points import ints_to_limbs, packed_to_limb_rows

    K, n_prove = PIPELINE_K, PROVE_K
    t0 = time.perf_counter()
    insts = [make_instance(rng, params, msg=b"wire %d" % i) for i in range(K)]
    pk_bytes = [encode_public_key(i.h, params) for i in insts]
    sig_bytes = [compress_signature(i.sig_signed, i.nonce, params)
                 for i in insts]
    msgs = [i.msg for i in insts]
    log(f"main path: {K} Falcon-{params.n} wire triples built in "
        f"{time.perf_counter() - t0:.1f} s")

    pipe = ProverInputPipeline(params, pack=True)
    times = []
    for _ in range(2):  # cold (compiles), then warm
        t0 = time.perf_counter()
        out = pipe.run_wire(pk_bytes, msgs, sig_bytes)
        jax.block_until_ready(out.packed)
        times.append(time.perf_counter() - t0)
    log(f"pipeline run_wire K={K} (codec: {pipe.codec}): cold "
        f"{times[0]:.2f} s, warm {times[1]:.2f} s")

    compiled = compile_circuit(FalconNTTVerificationCircuit, insts[0])
    rs = ResidueSystem(compiled)
    pk_ntt = np.asarray(out.pk_ntt)
    hm_ntt = np.asarray(out.hm_ntt)
    instance_vals = np.concatenate(
        [np.ones((K, 1), np.int64), pk_ntt, hm_ntt], axis=1
    )
    t0 = time.perf_counter()
    wres = rs.witness_residues_from_packed(instance_vals, out.packed)
    t_res = time.perf_counter() - t0
    verdict, cold = timed(rs.check_device, wres)
    _, warm = timed(rs.check_device, wres)
    if not np.asarray(verdict).all():
        raise AssertionError(
            f"CRT check rejected {int((~np.asarray(verdict)).sum())} of {K}"
        )
    log(f"CRT satisfiability: all {K} valid; host residues {t_res:.2f} s, "
        f"device check cold {cold:.2f} s, warm {warm:.3f} s")
    del wres

    m = 8
    bad = [i.msg for i in insts[:m]]
    bad[-1] = b"tampered"
    ok = verify_batch(
        np.stack([i.h for i in insts[:m]]), bad,
        [i.nonce for i in insts[:m]],
        np.stack([i.sig_signed for i in insts[:m]]), params,
    )
    if not (ok[:-1].all() and not ok[-1]):
        raise AssertionError(f"verify_batch with one tampered: {ok.tolist()}")
    log(f"verify_batch: {m - 1} valid accepted, tampered rejected")

    log(f"groth16 field tier: {native_backend.field_tier()}")
    crs = cache_dir() / f"FalconNTTVerificationCircuit_{params.n}.pk.npz"
    t0 = time.perf_counter()
    if crs.exists():
        pk = load_pk(crs)
        how = "loaded"
    else:
        pk = setup(compiled)
        crs.parent.mkdir(parents=True, exist_ok=True)
        save_pk(pk, crs)
        how = "set up and cached"
    log(f"CRS {how}: {time.perf_counter() - t0:.1f} s")
    packed = np.asarray(out.packed[:n_prove])
    publics = [[1] + [int(v) for v in np.concatenate([pk_ntt[i], hm_ntt[i]])]
               for i in range(n_prove)]
    assigns = [
        np.concatenate([ints_to_limbs(publics[i], 4),
                        packed_to_limb_rows(packed[i])])
        for i in range(n_prove)
    ]
    t0 = time.perf_counter()
    proofs = prove_batch(pk, compiled, assigns)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not all(verify(pk.vk, publics[i], proofs[i]) for i in range(n_prove)):
        raise AssertionError("a batched proof failed verification")
    log(f"prove_batch K={n_prove}: {t_prove:.2f} s; all proofs verify "
        f"({time.perf_counter() - t0:.2f} s)")
    return pk


# --- phase 5 ---------------------------------------------------------------


def phase_msm(rng, pk):
    from falcon_r1cs_tpu.snark import bls12_381 as bls
    from falcon_r1cs_tpu.snark import native_backend, tpu_msm
    from falcon_r1cs_tpu.snark.points import G1Array, ints_to_limbs

    log_n = MSM_LOG_N
    m = 1 << log_n
    q = pk.h_query
    pts = G1Array(q.xs[:m], q.ys[:m], q.inf[:m])
    scalars = ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(m)], 4
    )
    t0 = time.perf_counter()
    got = tpu_msm.g1_msm_tpu(pts, scalars)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpu_msm.g1_msm_tpu(pts, scalars)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = native_backend.g1_msm(pts, scalars)
    t_native = time.perf_counter() - t0
    if got != want:
        raise AssertionError("device G1 MSM != native C MSM")
    log(f"device G1 MSM 2^{log_n}: bit-exact vs native C; cold {cold:.2f} s, "
        f"warm {warm:.3f} s, native {t_native:.3f} s")


# --- four cards --------------------------------------------------------------


def _assert_spread(out: dict, devices, label: str) -> None:
    for k, v in out.items():
        held = {s.device for s in v.addressable_shards}
        if held != set(devices):
            raise AssertionError(f"{label}[{k}] lives on {held}, not all 4")


def _assert_equal(sharded: dict, local: dict, label: str) -> None:
    for k in local:
        if not np.array_equal(np.asarray(sharded[k]), np.asarray(local[k])):
            raise AssertionError(f"{label}[{k}]: sharded != one card")


def phase_four(rng, params):
    import jax

    from falcon_r1cs_tpu import FalconNTTVerificationCircuit
    from falcon_r1cs_tpu.parallel.mesh import (
        make_mesh,
        place_batch,
        sharded_engine,
        sharded_engine_dual,
        sharded_engine_schoolbook,
    )
    from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem
    from falcon_r1cs_tpu.r1cs.coo import compile_circuit
    from falcon_r1cs_tpu.witness.engine import jitted_engine
    from falcon_r1cs_tpu.witness.engine_dual import jitted_engine_dual
    from falcon_r1cs_tpu.witness.engine_schoolbook import (
        jitted_engine_schoolbook,
    )
    from falcon_r1cs_tpu.witness.export_device import packer_ntt

    n = params.n
    devs = jax.devices()[:4]
    batches = engine_batches(rng, params)
    mesh_dp = make_mesh(4, batch_axis=4)
    mesh_sp = make_mesh(4, batch_axis=2)
    cases = [
        ("ntt DP 4", sharded_engine(n, mesh_dp), jitted_engine(n), "ntt",
         mesh_dp),
        ("ntt DP 2 x SP 2", sharded_engine(n, mesh_sp), jitted_engine(n),
         "ntt", mesh_sp),
        ("dual DP 4", sharded_engine_dual(n, mesh_dp), jitted_engine_dual(n),
         "dual", mesh_dp),
        ("schoolbook DP 4", sharded_engine_schoolbook(n, mesh_dp),
         jitted_engine_schoolbook(n), "schoolbook", mesh_dp),
    ]
    for label, sharded, single, key, mesh in cases:
        _, args = batches[key]
        placed = place_batch(mesh, *args)
        out, cold = timed(sharded, *placed)
        out, warm = timed(sharded, *placed)
        _assert_spread(out, devs, label)
        ref = single(*args)
        _assert_equal(out, ref, label)
        del out, ref
        log(f"four cards {label} B={args[0].shape[0]}: bit-exact vs one "
            f"card, spread over 4; cold {cold:.2f} s, "
            f"warm {warm * 1e3:.2f} ms")

    insts, args = batches["ntt"]
    compiled = compile_circuit(FalconNTTVerificationCircuit, insts[0])
    rs = ResidueSystem(compiled)
    b = 8
    seg = jitted_engine(n)(*(a[:b] for a in args))
    packed = packer_ntt(n)(seg)
    instance_vals = np.concatenate(
        [np.ones((b, 1), np.int64), args[1][:b], args[2][:b]], axis=1
    )
    wres = rs.witness_residues_from_packed(instance_vals, packed)
    single = np.asarray(rs.check_device(wres))
    sharded, cold = timed(
        lambda w: rs.check_device_sharded(w, mesh_dp, axis="batch"), wres
    )
    sharded = np.asarray(sharded)
    if not np.array_equal(single, sharded) or not single[:2].all():
        raise AssertionError(
            f"sharded CRT check {sharded.tolist()} != one card "
            f"{single.tolist()} (first two are real signatures)"
        )
    log(f"four cards check_device_sharded B={b}: equals one card "
        f"({int(single.sum())} of {b} satisfied, both real ones among "
        f"them); cold {cold:.2f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded phases only")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    from falcon_r1cs_tpu.params import get_params

    t_all = time.perf_counter()
    devs = phase_device(count)
    rng = np.random.default_rng(SEED)
    params = get_params(N)
    phases = (
        [("four", lambda: phase_four(rng, params))] if args.four else [
            ("engines", lambda: phase_engines(rng, params)),
            ("kernel", lambda: phase_kernel(rng)),
            ("main path", lambda: phase_main_path(rng, params)),
        ]
    )
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        results[name] = fn()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    if not args.four:
        t0 = time.perf_counter()
        phase_msm(rng, results["main path"])
        log(f"phase msm: {time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
