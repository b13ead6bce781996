"""The CUDA hint-NTT kernel (ops/ntt_hints.cu, ops/ntt_cuda.py).

The kernel itself has no interpreter, so on the CPU these tests cover
what surrounds it and the arithmetic it runs:

  * its stage tables and active-limb schedule,
  * a numpy replay of its exact limb sweep (per-limb carry chains in
    registers, active limbs only, top-down divmod) against the XLA path,
  * the constants the .cu file hard-codes against the Python ones,
  * the wrapper's output shapes and argument checks, and the nvcc
    command (Hopper, sm_90a).

The `gpu` test compares the compiled kernel with the XLA path on the
card; it skips elsewhere (chip_smoke.py phase 3 runs the same check).
"""

import re

import jax
import numpy as np
import pytest

from falcon_r1cs_tpu.ops import ntt_cuda
from falcon_r1cs_tpu.ops.limbs import LIMB_BITS, NUM_LIMBS
from falcon_r1cs_tpu.ops.ntt_limb import ntt_with_hints
from falcon_r1cs_tpu.params import FALCON_512, FALCON_1024, Q

PARAMS = [FALCON_512, FALCON_1024]


def replay_kernel(x, params):
    """The kernel's algorithm in numpy, thread by thread vectorized over
    the batch: int64 storage, with every intermediate asserted to fit the
    int32 registers the kernel uses."""
    table, bounds, active = ntt_cuda.stage_tables(params)
    n, log_n = params.n, params.log_n
    st = np.zeros((NUM_LIMBS, x.shape[0], n), np.int64)
    st[0] = x
    i = np.arange(n // 2)  # thread index
    for l in range(log_n):
        shift = log_n - 1 - l
        half = 1 << shift
        g = i >> shift
        j0 = (g << (shift + 1)) + (i & (half - 1))
        j1 = j0 + half
        s = table[(1 << l) + g].astype(np.int64)
        cv = c0 = c1 = 0
        for k in range(active[l]):
            u = st[k][:, j0]
            tv = st[k][:, j1] * s + cv
            v = tv & 0xFFFF
            cv = tv >> 16
            o0 = u + v + c0
            o1 = u + (int(bounds[l + 1][k]) - v) + c1
            for val in (tv, o0, o1):
                assert -(2**31) <= val.min() and val.max() < 2**31
            st[k][:, j0] = o0 & 0xFFFF
            st[k][:, j1] = o1 & 0xFFFF
            c0, c1 = o0 >> 16, o1 >> 16
    t = np.zeros_like(st)
    r = np.zeros(st.shape[1:], np.int64)
    for k in range(NUM_LIMBS - 1, -1, -1):
        cur = (r << 16) + st[k]
        assert cur.max() < 2**31
        t[k] = cur // Q
        r = cur - t[k] * Q
    return t, r


@pytest.mark.parametrize("params", PARAMS)
def test_kernel_limb_sweep_matches_xla(rng, params):
    x = rng.integers(0, Q, size=(6, params.n)).astype(np.int32)
    x[0] = Q - 1  # the largest coefficients drive the largest carries
    x[1] = 0
    t_ref, b_ref = jax.jit(lambda x: ntt_with_hints(x, params))(x)
    t, b = replay_kernel(x, params)
    assert np.array_equal(np.asarray(t_ref), t)
    assert np.array_equal(np.asarray(b_ref), b)


@pytest.mark.parametrize("params", PARAMS)
def test_stage_tables(params):
    table, bounds, active = ntt_cuda.stage_tables(params)
    assert table.dtype == bounds.dtype == active.dtype == np.int32
    assert table.shape == (params.n,)
    assert list(table) == list(params.ntt_table)
    assert bounds.shape == (params.log_n + 1, NUM_LIMBS)
    for row, c in zip(bounds, params.const_q_powers):
        assert sum(int(v) << (LIMB_BITS * k) for k, v in enumerate(row)) == c
    assert active.shape == (params.log_n,)
    for l, a in enumerate(active.tolist()):
        # stage l's outputs stay below 2 * const[l + 1]; two bits of
        # headroom, and the limbs above `a` of that bound are zero
        c = params.const_q_powers[l + 1]
        assert 2 * c < 1 << (LIMB_BITS * a) or a == NUM_LIMBS
        assert not bounds[l + 1][a:].any()
    assert list(active) == sorted(active)


def test_cuda_source_constants_match_python():
    src = ntt_cuda._SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert const("kLimbs") == NUM_LIMBS
    assert const("kLimbBits") == LIMB_BITS
    assert const("kQ") == Q
    # the handler symbol the wrapper registers
    assert "XLA_FFI_DEFINE_HANDLER_SYMBOL(FalconNttHints" in src
    # one signature's limb state fits a block's static shared memory
    assert NUM_LIMBS * 1024 * 4 <= 48 * 1024


@pytest.mark.parametrize("params", PARAMS)
def test_wrapper_shapes(monkeypatch, params):
    """Output shapes of the FFI call, by abstract evaluation (no build)."""
    monkeypatch.setattr(ntt_cuda, "register", lambda: None)
    x = jax.ShapeDtypeStruct((5, params.n), np.int16)
    t, b = jax.eval_shape(
        lambda x: ntt_cuda.ntt_with_hints_cuda(x, params), x
    )
    assert (t.shape, t.dtype) == ((NUM_LIMBS, 5, params.n), np.int32)
    assert (b.shape, b.dtype) == ((5, params.n), np.int32)


def test_wrapper_rejects_wrong_degree(monkeypatch):
    monkeypatch.setattr(ntt_cuda, "register", lambda: None)
    x = jax.ShapeDtypeStruct((2, 512), np.int32)
    with pytest.raises(ValueError, match="coefficients"):
        jax.eval_shape(
            lambda x: ntt_cuda.ntt_with_hints_cuda(x, FALCON_1024), x
        )


def test_build_command_targets_hopper():
    cmd = ntt_cuda.build_command()
    assert cmd[0].endswith("nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and str(ntt_cuda._SRC) in cmd
    assert jax.ffi.include_dir() in cmd


@pytest.mark.gpu
@pytest.mark.parametrize("params", PARAMS)
def test_kernel_matches_xla_on_gpu(gpu, rng, params):
    x = rng.integers(0, Q, size=(1024, params.n)).astype(np.int32)
    want = jax.jit(lambda x: ntt_with_hints(x, params))(x)
    got = jax.jit(lambda x: ntt_cuda.ntt_with_hints_cuda(x, params))(x)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
