"""Parallelism layer on the virtual 8-device CPU mesh: sharded NTT
correctness, sharded engine parity, scaling harness, aux utils."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from falcon_r1cs_tpu.falcon import ntt
from falcon_r1cs_tpu.params import FALCON_512, FALCON_1024, Q
from falcon_r1cs_tpu.parallel.distributed import global_mesh, scaling_sweep
from falcon_r1cs_tpu.parallel.mesh import make_mesh, place_batch, sharded_engine
from falcon_r1cs_tpu.parallel.ntt_sharded import ntt_sharded
from falcon_r1cs_tpu.utils.config import RuntimeConfig
from falcon_r1cs_tpu.utils.counters import CounterLog
from falcon_r1cs_tpu.r1cs import ConstraintSystem, FpVar
from falcon_r1cs_tpu.gadgets import enforce_less_than_q
from falcon_r1cs_tpu.witness import jitted_engine


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_ntt_sharded_matches_clear(rng, d, params):
    mesh = Mesh(np.asarray(jax.devices()[:d]).reshape(d), ("coeff",))
    f = ntt_sharded(mesh, params)
    x = rng.integers(0, Q, size=(3, params.n)).astype(np.int32)
    assert np.array_equal(np.asarray(f(x)), ntt(x))


@pytest.mark.parametrize("batch_axis", [8, 4, 2, 1])
def test_sharded_engine_matches_single_device(rng, batch_axis):
    """Every (batch, coeff) factorization of the 8-device mesh — including
    the pure sequence-parallel coeff=8 — is bit-equal to one device."""
    n = 512
    mesh = make_mesh(8, batch_axis=batch_axis)
    batch = 8
    sig = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    pk = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    args = place_batch(mesh, sig, pk, hm)
    out_sharded = sharded_engine(n, mesh)(*args)
    out_local = jitted_engine(n)(sig, pk, hm)
    for k in out_local:
        assert np.array_equal(
            np.asarray(out_sharded[k]), np.asarray(out_local[k])
        ), k


def test_sharded_engine_collective_schedule():
    """The coeff-sharded engine's compiled HLO contains exactly
    2 * log2(D) collective-permutes (one per cross-shard stage of each of
    the two hint NTTs) — the explicit ppermute schedule, not GSPMD
    guesswork."""
    n = 512
    mesh = make_mesh(8, batch_axis=1)  # coeff = 8
    fn = sharded_engine(n, mesh)
    sig = np.zeros((2, n), np.int32)
    txt = fn.lower(sig, sig, sig).compile().as_text()
    assert txt.count("collective-permute(") + txt.count(
        "collective-permute-start("
    ) == 2 * 3  # 2 hint NTTs x log2(8) exchange stages


def test_sharded_engine_dual_matches_single_device(rng):
    from falcon_r1cs_tpu.parallel.mesh import sharded_engine_dual
    from falcon_r1cs_tpu.witness.engine_dual import jitted_engine_dual

    n = 512
    mesh = make_mesh(8, batch_axis=8)
    sig = rng.integers(-6144, 6145, size=(8, n)).astype(np.int32)
    pk = rng.integers(0, Q, size=(8, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(8, n), dtype=np.int32)
    out_sharded = sharded_engine_dual(n, mesh)(sig, pk, hm)
    out_local = jitted_engine_dual(n)(sig, pk, hm)
    for k in out_local:
        assert np.array_equal(
            np.asarray(out_sharded[k]), np.asarray(out_local[k])
        ), k


def test_sharded_engine_schoolbook_matches_single_device(rng):
    from falcon_r1cs_tpu.parallel.mesh import sharded_engine_schoolbook
    from falcon_r1cs_tpu.witness.engine_schoolbook import (
        jitted_engine_schoolbook,
    )

    n = 512
    mesh = make_mesh(8, batch_axis=8)
    sig = rng.integers(0, Q, size=(8, n), dtype=np.int32)
    pk = rng.integers(0, Q, size=(8, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(8, n), dtype=np.int32)
    out_sharded = sharded_engine_schoolbook(n, mesh)(sig, pk, hm)
    out_local = jitted_engine_schoolbook(n)(sig, pk, hm)
    for k in out_local:
        assert np.array_equal(
            np.asarray(out_sharded[k]), np.asarray(out_local[k])
        ), k


def test_pallas_capability_probe():
    """The hint-NTT backend is keyed on the platform alone — no probe
    kernel, no error-message matching: the CPU runs the XLA path, a GPU
    the CUDA kernel, and the engines here use the CPU's choice."""
    from falcon_r1cs_tpu.ops.backend import (
        KERNELS,
        configured_ntt_backend,
        ntt_backend,
    )

    assert jax.default_backend() == "cpu"
    assert configured_ntt_backend() == "xla"
    assert KERNELS == {"gpu": "cuda"}
    assert ntt_backend(None, "gpu") == "cuda"
    assert ntt_backend(False, "gpu") == "xla"


def test_scaling_sweep_runs():
    pts = scaling_sweep(n=512, batch_per_device=4)
    assert pts and pts[0].devices == 1
    assert pts[-1].devices == len(jax.devices())


def test_global_mesh_axes():
    mesh = global_mesh(batch_axis=4)
    assert mesh.shape == {"batch": 4, "coeff": 2}


def test_counter_log():
    cs = ConstraintSystem(validate=False)
    log = CounterLog(cs)
    a = FpVar.new_witness(cs, 5)
    with log.section("range"):
        enforce_less_than_q(cs, a)
    assert log.sections[0].constraints == 29
    assert log.sections[0].witness == 27
    assert "range" in log.table()


def test_runtime_config_env(monkeypatch):
    monkeypatch.setenv("FALCON_TPU_DEFAULT_N", "512")
    monkeypatch.setenv("FALCON_TPU_USE_NTT_KERNEL", "true")
    cfg = RuntimeConfig.from_env()
    assert cfg.default_n == 512
    assert cfg.use_ntt_kernel is True
    monkeypatch.setenv("FALCON_TPU_USE_NTT_KERNEL", "auto")
    assert RuntimeConfig.from_env().use_ntt_kernel is None


def test_sharded_sat_check_matches_single(rng, inst_512):
    from falcon_r1cs_tpu import FalconNTTVerificationCircuit
    from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem
    from falcon_r1cs_tpu.r1cs.coo import CompiledR1CS

    cs = ConstraintSystem()
    FalconNTTVerificationCircuit.build_circuit(inst_512).generate_constraints(cs)
    rs = ResidueSystem(CompiledR1CS.from_cs(cs))
    assign = np.asarray([cs.full_assignment()], dtype=object)
    wres = rs.witness_residues(assign)
    mesh = make_mesh(8, batch_axis=8)
    ok = rs.check_device_sharded(wres, mesh, axis="batch")
    assert ok[0]
    bad = np.array(assign)
    bad[0, 5555] = int(bad[0, 5555]) + 1
    assert not rs.check_device_sharded(
        rs.witness_residues(bad), mesh, axis="batch"
    )[0]


def test_multihost_two_process_smoke():
    """Real jax.distributed cluster: two local processes, gloo collectives,
    8 global devices, per-host input shards assembled into global arrays,
    one sharded witness-engine step (tools/multihost_smoke.py)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "tools" / "multihost_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    res = subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        timeout=420,
        env=env,
    )
    assert res.returncode == 0, res.stdout.decode()[-2000:]
    assert b"multihost smoke: PASS" in res.stdout
