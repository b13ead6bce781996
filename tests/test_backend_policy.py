"""Backend selection (keyed on the platform) and profiler trace accounting.

The hint-NTT backend is chosen from `jax.default_backend()` alone
(ops/backend.py): the CUDA kernel on a GPU, the XLA path elsewhere, a
strict preference for a kernel that does not exist raises.  Engines are
checked by tracing them under a patched platform with the kernel wrapper
replaced by a recording stand-in, so no GPU is needed.
"""

import gzip
import json

import jax
import numpy as np
import pytest

from falcon_r1cs_tpu.ops import ntt_cuda
from falcon_r1cs_tpu.ops.backend import ntt_backend
from falcon_r1cs_tpu.ops.ntt_limb import ntt_with_hints
from falcon_r1cs_tpu.utils import config as config_mod


def test_engine_cache_keys_on_platform_and_pref():
    """jitted_engine resolves the backend per (n, backend) — a config or
    platform change yields a fresh engine, not a stale one."""
    from falcon_r1cs_tpu.witness.engine import _jitted_engine, jitted_engine

    e1 = jitted_engine(512)
    e2 = jitted_engine(512)
    assert e1 is e2  # cached
    assert e1 is _jitted_engine(512, "xla")  # the CPU's choice
    ex = _jitted_engine(512, "cuda")
    assert ex is not e1
    assert _jitted_engine(512, "cuda") is ex


@pytest.mark.parametrize(
    "pref, platform, want",
    [
        (None, "cpu", "xla"),
        (False, "cpu", "xla"),
        (None, "gpu", "cuda"),
        (True, "gpu", "cuda"),
        (False, "gpu", "xla"),
        (None, "rocm", "xla"),
    ],
)
def test_ntt_backend_selection(pref, platform, want):
    assert ntt_backend(pref, platform) == want


@pytest.fixture()
def runtime_config():
    """Restore the process-wide RuntimeConfig after a test changes it."""
    prev = config_mod.get_config()
    yield config_mod
    config_mod.set_config(prev)


def _engine_factories():
    from falcon_r1cs_tpu.witness import engine, engine_dual

    return {
        "ntt": (engine.jitted_engine, engine._jitted_engine),
        "dual": (engine_dual.jitted_engine_dual,
                 engine_dual._jitted_engine_dual),
    }


@pytest.mark.parametrize("engine", ["ntt", "dual"])
def test_strict_pallas_pref_fails_loudly_on_cpu(runtime_config, engine):
    """use_ntt_kernel=True is strict: on a platform with no hint-NTT
    kernel (the CPU) building the engine raises instead of silently
    running the XLA path."""
    factory, _ = _engine_factories()[engine]
    runtime_config.set_config(
        config_mod.RuntimeConfig(use_ntt_kernel=True)
    )
    with pytest.raises(RuntimeError, match="no hint-NTT kernel"):
        factory(512)
    with pytest.raises(RuntimeError):
        ntt_backend(True, "cpu")


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("engine", ["ntt", "dual", "schoolbook"])
def test_engines_select_platform_kernel(monkeypatch, platform, engine):
    """On a GPU the NTT and dual engines trace through the CUDA kernel's
    wrapper, on the CPU through the XLA path; the schoolbook engine has
    no hint NTT and is the same XLA program everywhere."""
    from falcon_r1cs_tpu.witness import engine_schoolbook

    calls = []

    def stand_in(x, params):
        calls.append(params.n)
        return ntt_with_hints(x, params)

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(ntt_cuda, "ntt_with_hints_cuda", stand_in)
    factories = _engine_factories()
    if engine == "schoolbook":
        engine_schoolbook.jitted_engine_schoolbook.cache_clear()
        fn = engine_schoolbook.jitted_engine_schoolbook(512)
    else:
        factory, cached = factories[engine]
        cached.cache_clear()
        fn = factory(512)
    x = jax.ShapeDtypeStruct((2, 512), np.int32)
    jax.eval_shape(fn, x, x, x)
    kernel_expected = platform == "gpu" and engine != "schoolbook"
    assert bool(calls) == kernel_expected, calls
    if engine == "schoolbook":
        engine_schoolbook.jitted_engine_schoolbook.cache_clear()
    else:
        factories[engine][1].cache_clear()


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_time_trace_accounting(tmp_path):
    """On a GPU trace, the per-op and stream rows of "/device:GPU:<i>"
    count, the "XLA Modules" row does not (its spans cover a module's
    gaps), and overlapping or NESTED events (the same kernel on the op
    row and its stream row; a `while` spanning its inner ops) are
    unioned, not summed."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench import device_time_us_from_trace

    events = [
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 1,
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 2,
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 3,
         "args": {"name": "Stream #13(Compute)"}},
        # module-row total deliberately LARGER than the busy time so the
        # assertion discriminates which rows were counted
        {"ph": "X", "pid": 7, "tid": 1, "ts": 0, "dur": 5000,
         "name": "module"},
        {"ph": "X", "pid": 7, "tid": 2, "ts": 0, "dur": 600,
         "name": "fusion.1"},
        {"ph": "X", "pid": 7, "tid": 3, "ts": 0, "dur": 600,
         "name": "fusion_kernel_1"},
        {"ph": "X", "pid": 7, "tid": 2, "ts": 600, "dur": 400,
         "name": "fusion.2"},
        # a while row spans [1000, 2000) AND its inner ops are emitted
        # individually — union must count that second as once, not twice
        {"ph": "X", "pid": 7, "tid": 2, "ts": 1000, "dur": 1000,
         "name": "while.1"},
        {"ph": "X", "pid": 7, "tid": 3, "ts": 1000, "dur": 500,
         "name": "loop_kernel"},
        {"ph": "X", "pid": 7, "tid": 3, "ts": 1500, "dur": 500,
         "name": "loop_kernel"},
        # host events must be excluded entirely
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 9, "ts": 0, "dur": 99999,
         "name": "python"},
    ]
    _write_trace(tmp_path, events)
    assert device_time_us_from_trace(str(tmp_path)) == 2000


def test_device_time_reads_gpu_stream_rows(tmp_path):
    """A trace as the H100 writes it has no "XLA Ops" row: kernels sit on
    "Stream #<id>(Compute)" rows and copies on "(MemcpyH2D)" rows, and
    both are device work.  A "/device:CPU:0" process is not a GPU."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench import _is_device_row, device_time_us_from_trace

    events = [
        {"ph": "M", "name": "process_name", "pid": 3,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 3, "tid": 13,
         "args": {"name": "Stream #13(Compute)"}},
        {"ph": "M", "name": "thread_name", "pid": 3, "tid": 14,
         "args": {"name": "Stream #14(MemcpyH2D)"}},
        {"ph": "X", "pid": 3, "tid": 14, "ts": 0, "dur": 100,
         "name": "MemcpyH2D"},
        {"ph": "X", "pid": 3, "tid": 13, "ts": 150, "dur": 80,
         "name": "ntt_hints_kernel"},
        {"ph": "M", "name": "process_name", "pid": 4,
         "args": {"name": "/device:CPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 4, "tid": 1,
         "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 4, "tid": 1, "ts": 0, "dur": 7777,
         "name": "fusion"},
    ]
    _write_trace(tmp_path, events)
    assert device_time_us_from_trace(str(tmp_path)) == 180
    assert _is_device_row("/device:GPU:1", "Stream #7(Compute)")
    assert not _is_device_row("/device:GPU:0", "XLA Modules")
    assert not _is_device_row("/host:CPU", "XLA Ops")


def test_g1_backend_policy_is_measured_and_overridable(monkeypatch):
    """choose_g1_backend: host C whenever it builds, pure Python
    otherwise; the device MSM only by name; env wins outright."""
    from falcon_r1cs_tpu.snark import backend_policy as bp

    monkeypatch.delenv("FALCON_R1CS_TPU_G1_BACKEND", raising=False)
    assert bp.choose_g1_backend(True) == "native"
    assert bp.choose_g1_backend(False) == "python"
    # env override wins outright; junk values fail loudly
    monkeypatch.setenv("FALCON_R1CS_TPU_G1_BACKEND", "tpu")
    assert bp.choose_g1_backend(True) == "tpu"
    monkeypatch.setenv("FALCON_R1CS_TPU_G1_BACKEND", "python")
    assert bp.choose_g1_backend(True) == "python"
    monkeypatch.setenv("FALCON_R1CS_TPU_G1_BACKEND", "cuda")
    with pytest.raises(ValueError):
        bp.choose_g1_backend(True)


def test_prove_auto_resolves_through_policy(monkeypatch):
    """groth16.prove(g1_backend="auto") consults the policy: with the
    native library reported absent, the pure-python G1 path must produce
    a verifying proof."""
    from falcon_r1cs_tpu import ConstraintSystem
    from falcon_r1cs_tpu.r1cs.wires import FpVar
    from falcon_r1cs_tpu.r1cs.coo import CompiledR1CS
    from falcon_r1cs_tpu.snark import groth16

    monkeypatch.delenv("FALCON_R1CS_TPU_G1_BACKEND", raising=False)

    # a 3-wire toy circuit: prove knowledge of x with x*x = 9
    cs = ConstraintSystem(mode="prove")
    x = FpVar.new_witness(cs, 3)
    y = FpVar.new_input(cs, 9)
    (x * x).enforce_equal(y)
    compiled = CompiledR1CS.from_cs(cs)
    pk = groth16.setup(compiled, use_native=False)
    proof = groth16.prove(
        pk, compiled,
        list(cs.instance_values) + list(cs.witness_values),
        use_native=False,  # native absent -> policy must land on python
    )
    assert groth16.verify(pk.vk, list(cs.instance_values), proof)
